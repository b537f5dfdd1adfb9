"""``chip_smoke.py``'s float32 training-step check: the card's hard
alignment stands in for the CPU's only where the two are a tie on the CPU
(``path_tie``), built here from the port's ``viterbi_alignment`` on
log-probabilities that part by far less than a float32 rounding of the
path's score, and refused for a path that scores worse by a whole unit.
The aligner's CTC spans (phase 14) likewise, through ``ctc_path_tie``.
Also: ``alignment_ties.py``, which measures how often the devices part,
imports nothing of JAX; and ``check_st2_run`` reads a CPU StyleTTS2 run
as phase 12 calls it, and a CPU run with the pretrained components as
phase 13 calls it."""

import importlib.util
import shutil
from pathlib import Path

import pytest
import torch

from everyvoice_tpu_torch.models.fs2.alignment import _masked_log_softmax, viterbi_alignment

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "pydantic", "regex", "msgpack", "yaml", "PIL", "everyvoice_tpu")


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tied_logprob():
    """(1, 6, 3) log-probabilities whose frames 2–3 score the same on
    phones 1 and 2: every path that enters phone 2 at frame 2, 3 or 4 has
    the same score, and the search takes frame 2 (its backtrack stays on a
    phone at a tie)."""
    logp = torch.full((1, 6, 3), -6.0)
    logp[0, 0, 0] = logp[0, 1, 1] = logp[0, 4, 2] = logp[0, 5, 2] = -0.1
    logp[0, 2, 1:] = logp[0, 3, 1:] = -0.7
    return logp, torch.tensor([3]), torch.tensor([6])


def _path(logp, src, mel):
    hard = viterbi_alignment(logp, src, mel)
    return _masked_log_softmax(logp, src).double(), hard.double()


def test_path_tie_holds_for_paths_of_equal_score(chip_smoke):
    logp, src, mel = _tied_logprob()
    card = logp.clone()
    card[0, 3, 1] += 1e-5  # a rounding on the card: phone 2 from frame 4
    cpu_path, card_path = _path(logp, src, mel), _path(card, src, mel)
    assert cpu_path[1][0].argmax(-1).tolist() == [0, 1, 2, 2, 2, 2]
    assert card_path[1][0].argmax(-1).tolist() == [0, 1, 1, 1, 2, 2]
    tie = chip_smoke.path_tie(*card_path, *cpu_path)
    assert tie["frames_parted"] == 2
    assert abs(tie["score_gap"]) < 1e-6 <= tie["tie_bound"]
    same = chip_smoke.path_tie(*cpu_path, *cpu_path)
    assert same == {"frames_parted": 0, "score_gap": 0.0, "tie_bound": same["tie_bound"]}


def test_path_tie_refuses_a_worse_path(chip_smoke):
    logp, src, mel = _tied_logprob()
    late = logp.clone()
    late[0, 3, 1] += 1e-5
    late_path = _path(late, src, mel)[1]
    logp[0, 3, 1] -= 1.0  # staying on phone 1 at frame 3 costs a whole unit
    cpu_path = _path(logp, src, mel)
    # A card whose log-probabilities equal the CPU's, yet whose search
    # returned the later path.
    tie = chip_smoke.path_tie(cpu_path[0], late_path, *cpu_path)
    assert tie["frames_parted"] == 2
    assert tie["score_gap"] == pytest.approx(1.0, abs=1e-3)
    assert tie["score_gap"] > tie["tie_bound"]


def _tied_ctc():
    """(6, 3) CTC log-probabilities of targets [1, 2] whose frames 2–3 score
    the same on both labels: every path that enters label 2 at frame 2, 3
    or 4 has the same score."""
    import numpy as np

    lp = np.full((6, 3), -6.0, np.float32)
    lp[0:2, 1] = lp[4:6, 2] = -0.1
    lp[2:4, 1:] = -0.7
    return lp


def test_ctc_path_tie_holds_for_spans_of_equal_score(chip_smoke):
    from everyvoice_tpu_torch.models.aligner.segment import ctc_forced_alignment

    lp = _tied_ctc()
    card = lp.copy()
    card[2:4, 1] += 1e-5  # a rounding on the card: label 2 from frame 4
    spans_cpu, spans_card = ctc_forced_alignment(lp, [1, 2]), ctc_forced_alignment(card, [1, 2])
    assert spans_cpu == [(0, 0, 2), (1, 2, 6)] and spans_card == [(0, 0, 4), (1, 4, 6)]
    tie = chip_smoke.ctc_path_tie(spans_card, spans_cpu, card, lp, [1, 2])
    assert tie["frames_parted"] == 2
    assert abs(tie["score_gap"]) < 1e-6 <= tie["tie_bound"]
    same = chip_smoke.ctc_path_tie(spans_cpu, spans_cpu, lp, lp, [1, 2])
    assert same == {"frames_parted": 0, "score_gap": 0.0, "tie_bound": same["tie_bound"]}


def test_ctc_path_tie_refuses_worse_spans(chip_smoke):
    lp = _tied_ctc()
    lp[3, 1] -= 1.0  # label 1 at frame 3 costs a whole unit
    # A card whose log-probabilities equal the CPU's, yet whose search
    # kept label 1 through frame 3.
    tie = chip_smoke.ctc_path_tie([(0, 0, 4), (1, 4, 6)], [(0, 0, 2), (1, 2, 6)], lp, lp, [1, 2])
    assert tie["frames_parted"] == 2
    assert tie["score_gap"] == pytest.approx(1.0, abs=1e-6)
    assert tie["score_gap"] > tie["tie_bound"]


def test_alignment_ties_imports_nothing_of_jax():
    source = (REPO / "alignment_ties.py").read_text()
    for name in FORBIDDEN:
        assert f"import {name}" not in source and f"from {name} " not in source
        assert f"from {name}." not in source


@pytest.fixture(autouse=True)
def drop_checkpoints(tmp_path):
    """A test's StyleTTS2 run (about 1 GB of checkpoints) is deleted when it
    ends, not with the session's temporary directory."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def one_torch_thread():
    """torch on one thread beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_check_st2_run_reads_a_stage_run(chip_smoke, tmp_path, monkeypatch, one_torch_thread):
    """``check_st2_run`` (phase 12) passes a CPU stage-1 run of a small
    StyleTTS2 over two epochs of one synthetic batch, returning its
    training records, and fails on a checkpoint whose stage tag is not the
    run's."""
    from everyvoice_tpu_torch.config import styletts2_config
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.train import checkpoint
    from test_torch_cuda import _st2_batch

    config = styletts2_config({
        "contact": {"contact_name": "Smoke", "contact_email": "smoke@example.org"},
        "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 20,
                  "decoder": {"mpd_layers": [2], "msd_layers": 1, "upsample_rates": [8],
                              "upsample_kernel_sizes": [16], "gen_istft_n_fft": 64,
                              "gen_istft_hop_size": 32},
                  "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                "head_features": 8}}},
        "training": {"max_len": 64, "decoder_segment_frames": 16, "epochs_1st": 2,
                     "losses": {"tma_epoch": 1},
                     "logger": {"save_dir": str(tmp_path), "name": "smoke"}},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}})

    class Data:
        text_processor = TextProcessor(config["text"])
        n_symbols = len(text_processor.symbols)
        items: list = []

        def batches(self, *args, **kwargs):
            yield {k: v.numpy() for k, v in _st2_batch("cpu").items()}

    trainer = StyleTTS2Trainer(config, Data(), Data(), {"default": 0}, run_dir=tmp_path / "run",
                               mode="first", device="cpu")
    trainer.fit(log_every=1)
    failures = []
    monkeypatch.setattr(chip_smoke, "fail", failures.append)
    records = chip_smoke.check_st2_run(trainer, "stage-1-last.ckpt", chip_smoke.ST2_GEN_KEYS)
    assert failures == [] and [r["step"] for r in records] == [1, 2]
    assert records[0]["training/gen/s2s"] == 0.0 < records[1]["training/gen/s2s"]
    load = checkpoint.load_checkpoint
    monkeypatch.setattr(checkpoint, "load_checkpoint", lambda path: {**load(path), "stage": "second"})
    chip_smoke.check_st2_run(trainer, "stage-1-last.ckpt", chip_smoke.ST2_GEN_KEYS)
    assert failures and "header or trees" in failures[0]


def test_check_st2_run_reads_a_regime2_run(chip_smoke, tmp_path, monkeypatch, one_torch_thread):
    """``check_st2_run`` as phase 13 calls it passes a CPU stage-2 run of a
    small StyleTTS2 with its four pretrained components (seeded files at
    small widths) and an out-of-domain bank over two epochs of one
    synthetic batch: the components' geometries in the headers,
    ``multi_transform``'s optimizer state, the SLM terms in every record and
    the out-of-domain ones from the joint epoch; it fails on a checkpoint
    whose generator's optimizer state is a single ``adamw``'s."""
    from everyvoice_tpu_torch.config import apply_overrides, styletts2_config
    from everyvoice_tpu_torch.models.styletts2.train import StyleTTS2Trainer
    from everyvoice_tpu_torch.onchip import TEXTS, pretrained_overrides, write_pretrained_components
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.train import checkpoint
    from everyvoice_tpu_torch.utils import write_filelist
    from test_torch_cuda import _st2_batch

    paths = write_pretrained_components(
        tmp_path / "pretrained", torch.Generator().manual_seed(0),
        jdc={"channels": (8, 8, 16, 16), "lstm_hidden": 8},
        asr={"input_dim": 80, "hidden_dim": 16, "n_token": 178, "n_layers": 1,
             "token_embedding_dim": 8},
        plbert={"vocab_size": 178, "hidden_size": 16, "num_layers": 1, "num_heads": 2,
                "intermediate_size": 32, "embedding_size": 8, "max_position_embeddings": 64},
        wavlm={"hidden_size": 16, "num_layers": 1, "num_heads": 2, "intermediate_size": 32,
               "conv_dim": (8,) * 7, "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
               "conv_stride": (5, 2, 2, 2, 2, 2, 2), "num_buckets": 32, "max_distance": 80,
               "num_conv_pos_embeddings": 15, "num_conv_pos_embedding_groups": 4})
    (tmp_path / "pre" / "ood").mkdir(parents=True)
    write_filelist([{"text": t} for t in TEXTS[:4]], tmp_path / "pre" / "ood" / "default.psv")
    config = styletts2_config(apply_overrides({
        "contact": {"contact_name": "Smoke", "contact_email": "smoke@example.org"},
        "model": {"hidden_dim": 32, "style_dim": 16, "max_dur": 20, "slm": {"initial_channel": 8},
                  "decoder": {"mpd_layers": [2], "msd_layers": 1, "upsample_rates": [8],
                              "upsample_kernel_sizes": [16], "gen_istft_n_fft": 64,
                              "gen_istft_hop_size": 32},
                  "diffusion": {"transformer": {"num_layers": 1, "num_heads": 2,
                                                "head_features": 8}}},
        "preprocessing": {"save_dir": str(tmp_path / "pre")},
        "training": {"max_len": 64, "decoder_segment_frames": 16, "epochs_2nd": 2,
                     "OOD_min_length": 10, "losses": {"diff_epoch": 1, "joint_epoch": 1},
                     "logger": {"save_dir": str(tmp_path), "name": "smoke"}},
        "text": {"symbols": {"letters": list("abcdefghijklmnopqrstuvwxyz")}}},
        pretrained_overrides(paths)))

    class Data:
        text_processor = TextProcessor(config["text"])
        n_symbols = len(text_processor.symbols)
        level = "characters"
        max_text_len = 12
        items: list = []

        def batches(self, *args, **kwargs):
            yield {k: v.numpy() for k, v in _st2_batch("cpu").items()}

    trainer = StyleTTS2Trainer(config, Data(), Data(), {"default": 0}, run_dir=tmp_path / "run",
                               mode="second", device="cpu")
    trainer.fit(log_every=1)
    components = {"plbert": trainer.plbert_geometry, "asr": trainer.asr_geometry}
    keys = chip_smoke.ST2_GEN_KEYS | {"gen/diff", "gen/sty", "gen/slm", "disc/slm"}
    failures = []
    monkeypatch.setattr(chip_smoke, "fail", failures.append)
    records = chip_smoke.check_st2_run(trainer, "stage-2-last.ckpt", keys, components,
                                       later_keys=chip_smoke.ST2P_LATER_KEYS)
    assert failures == [] and [r["step"] for r in records] == [1, 2]
    assert "training/gen/slm_ood" in records[1] and "training/gen/slm_ood" not in records[0]
    load = checkpoint.load_checkpoint

    def single_adamw(path):
        ckpt = load(path)
        ckpt["optimizer_states"]["gen"] = ckpt["optimizer_states"]["disc"]
        return ckpt

    monkeypatch.setattr(checkpoint, "load_checkpoint", single_adamw)
    chip_smoke.check_st2_run(trainer, "stage-2-last.ckpt", keys, components,
                             later_keys=chip_smoke.ST2P_LATER_KEYS)
    assert failures and "multi_transform" in failures[0]
