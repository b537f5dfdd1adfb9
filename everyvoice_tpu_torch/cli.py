"""The ``everyvoice-tpu-torch`` command line: the verbs of
``everyvoice-tpu`` (everyvoice_tpu/cli.py) that the port's slices serve,
with the same spellings, defaults and exit codes, on ``argparse``.

    python -m everyvoice_tpu_torch new-project
    python -m everyvoice_tpu_torch preprocess text-to-spec config/everyvoice-text-to-spec.yaml
    python -m everyvoice_tpu_torch preprocess text-to-spec config/...-text-to-spec.yaml --device-audio
    python -m everyvoice_tpu_torch train text-to-spec config/everyvoice-text-to-spec.yaml
    python -m everyvoice_tpu_torch train text-to-wav config/everyvoice-text-to-wav.yaml --mode first
    python -m everyvoice_tpu_torch synthesize from-text last.ckpt -t "Hello." --vocoder-path v.ckpt
    python -m everyvoice_tpu_torch synthesize text-to-wav styletts2.ckpt -t "Hello." -r ref.wav
    python -m everyvoice_tpu_torch demo last.ckpt --vocoder-path v.ckpt --port 7860
    python -m everyvoice_tpu_torch segment align long.wav transcript.txt --acoustic-model w2v2/
    python -m everyvoice_tpu_torch segment extract long.wav alignment.TextGrid -o segments

Config files are the JAX package's YAML or JSON project files
(``config_files.load_config_from_path``); ``-c key.path=value`` overrides
them. Checkpoints are EVTP files that either package reads.

``new-project`` is the wizard: it reads its answers from standard input,
so a process can drive it through a pipe. Every verb that computes runs on
the CUDA card and fails without one.
``EVERYVOICE_DEVICE=cpu`` puts every verb on the CPU; ``train``'s and
``demo``'s ``-a cpu`` does so for that verb. Flags that ask for what the
port does not have yet exit non-zero naming the ``ROADMAP.md`` item that
brings it.
``--help`` imports no torch: the heavy imports sit in the verbs' bodies.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter
from pathlib import Path

PROG = "everyvoice-tpu-torch"
VERSION = "0.1.0"
OUTPUT_TYPES = ("wav", "spec", "textgrid", "readalong-xml", "readalong-html")
STEPS = ("audio", "text", "pfs", "spec", "attn", "energy", "pitch", "ood")
ROADMAP_ITEMS = {
    "fetch_pretrained": "queue 1, 'fetch-pretrained'",
}


class CLIError(Exception):
    """A failure the command reports as ``Error: <message>`` with exit code 1."""


def not_ported(what: str, item: str) -> CLIError:
    return CLIError(f"{what} is not ported to the PyTorch package yet; see ROADMAP.md, "
                    f"{ROADMAP_ITEMS[item]}")


def _device(name=None):
    """The torch device a verb computes on: ``name``, else
    ``EVERYVOICE_DEVICE``, else the CUDA card (an error without one)."""
    from everyvoice_tpu_torch.device import resolve_device

    try:
        device = resolve_device(name or os.environ.get("EVERYVOICE_DEVICE") or None)
    except (RuntimeError, ValueError) as e:
        raise CLIError(f"{e} (on the command line: EVERYVOICE_DEVICE=cpu, or train -a cpu)"
                       ) from None
    print(f"device: {device}", file=sys.stderr, flush=True)
    return device


def _load_config(kind: str, path: Path, overrides):
    from everyvoice_tpu_torch.config_files import ConfigError, load_config_from_path

    try:
        return load_config_from_path(kind, path, overrides or ())
    except ConfigError as e:
        raise CLIError(str(e)) from None


# ---------------------------------------------------------------------------
# verbs


def new_project(args) -> int:
    from everyvoice_tpu_torch.wizard.main_tour import get_main_wizard_tour
    from everyvoice_tpu_torch.wizard.tour import StepError

    tour = get_main_wizard_tour(trace=args.trace, debug_state=args.debug_state)
    try:
        tour.run(resume_from=args.resume_from)
    except EOFError:
        raise CLIError("the input ended before the wizard's last question") from None
    except StepError as e:
        raise CLIError(str(e)) from None
    return 0


def preprocess(args) -> int:
    from everyvoice_tpu_torch.preprocessor import Preprocessor

    if args.debug:
        import logging

        logging.getLogger("everyvoice_tpu_torch").setLevel(logging.DEBUG)
    kind = args.model_kind
    config = _load_config(kind, args.config_path, args.config_args)
    steps = tuple(args.steps or ())
    if not steps:
        steps = (("audio", "spec") if kind == "spec-to-wav"
                 else ("audio", "text", "spec", "attn", "energy", "pitch")
                 + (("ood",) if kind == "text-to-wav" else ()))
    run_ood = "ood" in steps
    steps = tuple(s for s in steps if s != "ood")
    pre = Preprocessor(config, device=_device())
    if steps:
        pre.preprocess(to_process=steps, overwrite=args.overwrite, cpus=args.cpus,
                       device_audio=args.device_audio)
    if run_ood:
        ood_texts = _gather_ood_texts(config)
        if ood_texts:
            pre.preprocess_ood(ood_texts)
            print("Wrote OOD text for languages: " + ", ".join(sorted(ood_texts)))
        elif kind == "text-to-wav":
            print("No OOD sources configured (training.ood_raw_data / use_validation_as_ood) "
                  "— skipping the ood step.")
    return 0


def _gather_ood_texts(config: dict) -> dict:
    """Each language's out-of-domain sentences from the config's sources:
    ``training.ood_raw_data[lang].local_path`` (plain text or a psv) and,
    with ``use_validation_as_ood``, the validation filelist's texts. A
    HuggingFace source needs the network, which this package does not use:
    it is an error, naming the local file to give instead."""
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    training = config.get("training") or {}
    texts: dict = {}
    for lang, source in (training.get("ood_raw_data") or {}).items():
        lines: list = []
        local = source.get("local_path")
        hf = source.get("hf") or {}
        if local is not None and Path(local).is_file():
            lines = _ood_lines_from_raw(Path(local).read_text(encoding="utf8").splitlines())
        elif hf.get("repo_id"):
            where = "" if local is None else f" (its local_path {local} does not exist)"
            raise CLIError(
                f"The OOD source for '{lang}' is the HuggingFace dataset {hf['repo_id']}"
                f"{where}: fetching it needs the network, which the PyTorch package does not "
                f"use. Download {hf.get('filename')} and set "
                f"training.ood_raw_data.{lang}.local_path to it.")
        elif local is not None:
            print(f"OOD source for '{lang}' points at a missing file ({local}) and no "
                  "HuggingFace source is configured; skipping that language.", file=sys.stderr)
        lines = _filter_ood_lines(lines, training)
        if lines:
            texts[lang] = lines
    if training.get("use_validation_as_ood"):
        try:
            rows = generic_psv_filelist_reader(training["validation_filelist"])
        except OSError:
            rows = []
        by_lang: dict = {}
        for row in rows:
            text = (row.get("characters") or row.get("raw_text") or row.get("text")
                    or row.get("phones") or "")
            if text.strip():
                by_lang.setdefault(row.get("language") or "und", []).append(text)
        for lang, lines in by_lang.items():
            filtered = _filter_ood_lines(lines, training)
            if filtered:
                texts.setdefault(lang, filtered)
    return texts


def _filter_ood_lines(lines: list, training: dict) -> list:
    """The sentences of at least ``OOD_min_length`` characters; all of them
    (with a warning) where none is."""
    min_length = training.get("OOD_min_length") or 0
    kept = [line for line in lines if len(line) >= min_length]
    if lines and not kept:
        print(f"All {len(lines)} OOD sentences are shorter than OOD_min_length={min_length}; "
              "keeping them anyway (lower OOD_min_length to silence this).", file=sys.stderr)
        return lines
    return kept


def _ood_lines_from_raw(raw_lines: list) -> list:
    """One sentence a line, or a psv's ``phones``, ``characters`` or
    ``text`` column (the first of them in its header)."""
    if not raw_lines:
        return []
    header = [f.strip() for f in raw_lines[0].split("|")]
    for column in ("phones", "characters", "text"):
        if column in header:
            import csv

            reader = csv.DictReader(raw_lines, delimiter="|", quoting=csv.QUOTE_NONE,
                                    escapechar="\\")
            return [(row.get(column) or "").strip() for row in reader
                    if (row.get(column) or "").strip()]
    return [line.strip() for line in raw_lines if line.strip()]


def _accelerator(accelerator: str):
    """The device name ``-a/--accelerator`` asks for: cpu the CPU, gpu the
    card, auto the card unless ``EVERYVOICE_DEVICE`` says otherwise; tpu is
    an error."""
    if accelerator == "tpu":
        raise CLIError("--accelerator tpu: the PyTorch package runs on a CUDA card "
                       "(auto or gpu) or on the CPU (cpu)")
    return {"cpu": "cpu", "gpu": "cuda"}.get(accelerator)


def _train_plan(args) -> tuple:
    """(device type, strategy) of a ``train`` command, its flags checked
    before any worker starts."""
    from everyvoice_tpu_torch.parallel.mesh import resolve_devices
    from everyvoice_tpu_torch.parallel.sharding import parse_strategy

    try:
        strategy = parse_strategy(args.strategy)
    except ValueError as e:
        raise CLIError(str(e)) from None
    if args.devices != "auto":
        try:
            int(args.devices)
        except ValueError:
            raise CLIError(f"--devices {args.devices!r}: expected 'auto' or a count") from None
    if args.nodes < 1:
        raise CLIError(f"--nodes {args.nodes}: expected a positive count")
    kind = _device(_accelerator(args.accelerator)).type
    try:
        per_node = len(resolve_devices(kind, args.devices))
    except (RuntimeError, ValueError) as e:
        raise CLIError(str(e)) from None
    if (per_node * args.nodes) % strategy.model_parallel:
        raise CLIError(f"--strategy {args.strategy}: {per_node * args.nodes} device(s) do not "
                       f"split into tensor-parallel groups of {strategy.model_parallel}")
    return kind, strategy


def fit_from_args(args, mesh=None, fsdp: bool = False, device=None):
    """The trained trainer of a parsed ``train`` command: as one rank of
    ``mesh``, or on ``device`` alone without one."""
    model_kind = args.model_kind
    config = _load_config(model_kind, args.config_path, args.config_args)
    options = {}
    if model_kind == "text-to-spec":
        from everyvoice_tpu_torch.train.text_to_spec import train_text_to_spec as fit
    elif model_kind == "spec-to-wav":
        from everyvoice_tpu_torch.train.spec_to_wav import train_spec_to_wav as fit
    else:
        from everyvoice_tpu_torch.train.text_to_wav import train_text_to_wav as fit

        options["mode"] = args.mode
    return fit(config, gradient_clip_val=args.gradient_clip_val,
               profile_steps=args.profile_steps, steps_per_execution=args.steps_per_execution,
               compute_precision=args.compute_precision, device=device, mesh=mesh, fsdp=fsdp,
               **options)


def _train_worker(local_rank: int, coordinator: str, args, kind: str, strategy) -> None:
    """One rank of ``train``: join the mesh, train, leave."""
    from everyvoice_tpu_torch.parallel.mesh import setup_mesh, teardown

    mesh = setup_mesh(kind, args.devices, args.nodes, strategy.model_parallel, local_rank,
                      address=coordinator)
    try:
        trainer = fit_from_args(args, mesh, strategy.fsdp)
        if not mesh.is_main:
            return
        if args.model_kind == "text-to-wav":
            print(f"Stage {args.mode} training complete; checkpoints at {trainer.ckpt_dir}",
                  flush=True)
        else:
            print(f"Training complete; checkpoints at {trainer.ckpt_dir}", flush=True)
    finally:
        teardown(mesh)


def train(args) -> int:
    """Train on ``--devices`` devices of each of ``--nodes`` nodes, one
    worker process a device, under ``--strategy``; a worker's failure fails
    the command."""
    import torch.multiprocessing as mp

    from everyvoice_tpu_torch.parallel.launch import launch

    kind, strategy = _train_plan(args)
    _load_config(args.model_kind, args.config_path, args.config_args)  # fail before the workers
    try:
        launch(_train_worker, (args, kind, strategy), kind, args.devices, args.nodes)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        raise CLIError(f"a training worker failed:\n{e}") from None
    return 0


def _filelist_texts(filelist) -> tuple:
    from everyvoice_tpu_torch.utils import generic_psv_filelist_reader

    rows = generic_psv_filelist_reader(filelist)
    return rows, [r.get("characters") or r.get("text") or "" for r in rows]


def _request_texts(args) -> tuple:
    """(texts, filelist rows or None, basenames or None): the ``-t`` texts,
    then the filelist's; the basenames are the filelist's, matched to the
    texts by position as the JAX CLI matches them."""
    texts = list(args.text or ())
    rows = basenames = None
    if args.filelist is not None:
        rows, filelist_texts = _filelist_texts(args.filelist)
        texts += filelist_texts
        basenames = [r.get("basename") for r in rows]
    if not texts:
        raise CLIError("Provide --text or --filelist")
    return texts, rows, basenames


def _model_kind(path) -> str:
    from everyvoice_tpu_torch.train.checkpoint import load_checkpoint_header

    try:
        return load_checkpoint_header(path)["model_info"]["name"]
    except ValueError as e:
        raise CLIError(str(e)) from None


def _synthesize_styletts2(model_path, texts, basenames, output_dir, language, speaker,
                          reference=None, **options) -> None:
    """Each text through StyleTTS2 into ``<output_dir>/wav/<base>--<speaker>
    --<language>.wav``, one at a time."""
    from everyvoice_tpu_torch.dsp import write_wav
    from everyvoice_tpu_torch.models.styletts2.synthesize import (
        load_reference_style,
        load_styletts2_model,
        synthesize_text,
    )
    from everyvoice_tpu_torch.utils import slugify, truncate_basename

    model, config, text_processor, _ = load_styletts2_model(model_path, device=_device())
    ref_styles = (load_reference_style(model, reference, config)
                  if reference is not None else None)
    out = Path(output_dir) / "wav"
    out.mkdir(parents=True, exist_ok=True)
    sr = config["preprocessing"]["audio"]["output_sampling_rate"]
    for i, text in enumerate(texts):
        wav = synthesize_text(model, config, text_processor, text, language=language,
                              ref_styles=ref_styles, **options)
        base = (basenames[i] if basenames and i < len(basenames)
                else truncate_basename(slugify(text)))
        path = out / f"{base}--{speaker}--{language or 'default'}.wav"
        write_wav(path, wav, sr)
        print(str(path))


def synthesize_from_text(args) -> int:
    from everyvoice_tpu_torch.models.fs2.synthesize import (
        Synthesizer,
        synthesize_teacher_forced_specs,
    )

    texts, rows, basenames = _request_texts(args)
    if _model_kind(args.model_path) == "StyleTTS2Module":
        # StyleTTS2 makes wavs itself, with the sampler's defaults.
        _synthesize_styletts2(args.model_path, texts, basenames, args.output_dir,
                              args.language, args.speaker or "default")
        return 0
    output_types = tuple(args.output_types or ("wav",))
    device = _device()
    synth = Synthesizer(args.model_path, vocoder_checkpoint=args.vocoder_path, device=device)
    if "wav" in output_types and args.vocoder_path is None:
        raise CLIError("wav output requires --vocoder-path (or synthesize spec first)")
    if args.teacher_forcing_directory is not None:
        if rows is None:
            raise CLIError("--teacher-forcing-directory requires --filelist (the "
                           "preprocessed training filelist)")
        count = synthesize_teacher_forced_specs(
            args.model_path, rows, synth.config,
            output_dir=args.teacher_forcing_directory, device=device)
        print(f"Wrote {count} teacher-forced spectrograms to "
              f"{args.teacher_forcing_directory}/synthesized_spec")
        return 0
    results = synth.synthesize(texts, language=args.language, speaker=args.speaker,
                               duration_control=args.duration_control,
                               style_reference=args.style_reference)
    for path in synth.write_outputs(results, args.output_dir, output_types,
                                    language=args.language, speaker=args.speaker,
                                    basenames=basenames):
        print(str(path))
    return 0


def synthesize_text_to_wav(args) -> int:
    name = _model_kind(args.model_path)
    if name != "StyleTTS2Module":
        raise CLIError(f"synthesize text-to-wav takes a StyleTTS2 checkpoint, not {name} — "
                       "use `synthesize from-text` for FastSpeech2 models.")
    texts, _, basenames = _request_texts(args)
    _synthesize_styletts2(
        args.model_path, texts, basenames, args.output_dir, args.language, "default",
        reference=args.reference, diffusion_steps=args.diffusion_steps,
        embedding_scale=args.embedding_scale, acoustic_blend=args.acoustic_blend,
        prosody_blend=args.prosody_blend, seed=args.seed)
    return 0


def synthesize_from_spec(args) -> int:
    import numpy as np
    import torch

    from everyvoice_tpu_torch.dsp import write_wav
    from everyvoice_tpu_torch.models.fs2.synthesize import load_vocoder_from_checkpoint

    device = _device()
    generator, config = load_vocoder_from_checkpoint(args.model_path, device=device)
    sr = config["preprocessing"]["audio"]["output_sampling_rate"]
    out = Path(args.output_dir) / "wav"
    out.mkdir(parents=True, exist_ok=True)
    count = 0
    for spec_path in sorted(Path(args.input_dir).glob("*.npy")):
        mel = torch.from_numpy(np.load(spec_path).T[None].astype(np.float32)).to(device)
        with torch.no_grad():
            wav = generator(mel)[0].float().cpu().numpy()
        path = out / f"{spec_path.stem.replace('--spec-pred', '')}.wav"
        write_wav(path, wav, sr)
        count += 1
        print(str(path))
    if count == 0:
        raise CLIError(f"No .npy spectrograms found in {args.input_dir}")
    return 0


def export_spec_to_wav(args) -> int:
    from everyvoice_tpu_torch.models.fs2.synthesize import export_generator

    path = export_generator(args.model_path, args.output_path)
    print(f"Exported generator to {path}")
    return 0


def checkpoint_inspect(args) -> int:
    from everyvoice_tpu_torch.train.checkpoint import inspect_checkpoint

    try:
        report = inspect_checkpoint(args.checkpoint_path, args.show_config,
                                    args.show_architecture)
    except ValueError as e:
        raise CLIError(str(e)) from None
    print(report)
    return 0


def checkpoint_rename_speaker(args) -> int:
    from everyvoice_tpu_torch.train.checkpoint import rename_speaker

    try:
        rename_speaker(args.checkpoint_path, args.old_name, args.new_name, args.output_path)
    except ValueError as e:
        raise CLIError(str(e)) from None
    print(f"Wrote {args.output_path}")
    return 0


def g2p(args) -> int:
    from everyvoice_tpu_torch.text.phonemizer import get_g2p_engine

    try:
        engine = get_g2p_engine(args.lang_id)
    except NotImplementedError as e:
        raise CLIError(str(e)) from None
    print(" ".join(engine(args.text)))
    return 0


def check_text_config(args) -> int:
    from everyvoice_tpu_torch.config_files import ConfigError, load_text_config_from_path
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.text.utils import guess_graphemes_in_text

    try:
        tp = TextProcessor(load_text_config_from_path(args.config_path))
    except ConfigError as e:
        raise CLIError(str(e)) from None
    missing: Counter = Counter()
    for text in _filelist_texts(args.filelist)[1]:
        for run in tp.get_missing_symbols(tp.normalize_text(text), quiet=True):
            for symbol in guess_graphemes_in_text(run):
                missing[symbol] += 1
    if not missing:
        print("No missing symbols — your configuration covers the data.")
        return 0
    print("Missing symbols (symbol: count):")
    for symbol, count in missing.most_common():
        print(f"  {symbol!r}: {count}")
    return 1


def check_pretrained_symbols(args) -> int:
    """Compare the config's symbols with the frozen pretrained symbol table
    and suggest substitutions for the missing ones (exit 1 when any is
    missing), as the JAX CLI's ``check pretrained-symbols``."""
    from everyvoice_tpu_torch.text import TextProcessor
    from everyvoice_tpu_torch.text.utils_heavy import suggest_symbol_mapping

    config = _load_config("text-to-wav", args.config_path, ())
    pretrained = list(config["pretrained"]["pretrained_symbols"] or ())
    if not pretrained:
        raise CLIError("No pretrained_symbols declared in the config's pretrained section.")
    user_symbols = sorted(s for s in TextProcessor(config["text"]).declared_symbols
                          if not (s.startswith("<") and s.endswith(">")))
    table = set(pretrained)
    missing = [s for s in user_symbols if s not in table]
    if not missing:
        print("All your symbols exist in the pretrained symbol table.")
        return 0
    print(f"{len(missing)} symbol(s) are not in the pretrained table.")
    print("Suggested substitutions (add as to_replace rules):")
    for user_symbol, replacement in sorted(suggest_symbol_mapping(user_symbols, pretrained).items()):
        print(f"  {user_symbol!r} -> {replacement!r}")
    return 1


def fetch_pretrained(args) -> int:
    raise not_ported("fetch-pretrained (it downloads from HuggingFace)", "fetch_pretrained")


def check_data(args) -> int:
    from everyvoice_tpu_torch.train.check_data import check_data as score

    config = _load_config("text-to-spec", args.config_path, ())
    rows = score(config, args.model_path, device=_device())
    Path(args.output).write_text(json.dumps(rows, indent=1), encoding="utf8")
    print(f"Wrote per-item loss report to {args.output}")
    print("Worst 5 items by total loss:")
    for row in rows[:5]:
        print(f"  {row['basename']}: {row['total']:.4f}")
    return 0


def evaluate(args) -> int:
    from everyvoice_tpu_torch.evaluation import evaluate_directory

    targets = [p for p in (args.wav_dir, args.audio_file, args.audio_directory) if p is not None]
    if len(targets) != 1:
        raise CLIError("Please choose to evaluate either a single file or an entire "
                       "directory (one of WAV_DIR_OR_FILE, --audio-file, or --audio-directory).")
    results = evaluate_directory(targets[0], reference_dir=args.reference_dir,
                                 non_matching_reference_dir=args.non_matching_references,
                                 device=_device())
    Path(args.output).write_text(json.dumps(results, indent=1), encoding="utf8")
    print(f"Wrote {args.output} ({len(results)} files)")
    numeric: dict = {}
    for row in results:
        for key, value in row.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                numeric.setdefault(key, []).append(float(value))
    if numeric:
        print("Averages:")
        for key in sorted(numeric):
            values = numeric[key]
            mean = sum(values) / len(values)
            std = (sum((v - mean) ** 2 for v in values) / len(values)) ** 0.5
            print(f"  {key}: {mean:.4f} ± {std:.4f} (n={len(values)})")
    if results and not any(r.get("has_quality_metrics") for r in results):
        print("WARNING: only signal diagnostics were produced — no quality scores. Pass "
              "--reference-dir for intrusive SI-SDR/STOI.", file=sys.stderr)
    return 0


def demo(args) -> int:
    if args.share:
        raise CLIError("--share is not supported: there is no tunnel service here. Bind a "
                       "public interface with --server-name 0.0.0.0 and expose the port instead.")
    if args.allowlist and args.denylist:
        raise CLIError("Provide either --allowlist or --denylist, not both.")
    device = _device(_accelerator(args.accelerator))
    from everyvoice_tpu_torch.demo.app import create_demo_app_auto, parse_ref_speakers

    ui_labels = None
    if args.ui_config:
        try:
            ui_labels = json.loads(Path(args.ui_config).read_text(encoding="utf8"))
        except json.JSONDecodeError as e:
            raise CLIError(f"--ui-config {args.ui_config} is not valid JSON: {e}") from None
        if not isinstance(ui_labels, dict):
            raise CLIError("--ui-config must contain a JSON object of label overrides")
    try:
        app = create_demo_app_auto(
            args.model_path, vocoder_path=args.vocoder_path, ref_audio_dir=args.ref_audio_dir,
            allowlist=args.allowlist, denylist=args.denylist, ui_labels=ui_labels,
            speakers=args.speakers or None, languages=args.languages or None,
            output_formats=args.output_formats or None, output_dir=args.output_dir,
            ref_speakers=parse_ref_speakers(args.ref_speakers),
            default_reference=args.reference, device=device,
        )
    except ValueError as e:
        raise CLIError(str(e)) from None
    print(f"Serving demo at http://{args.server_name}:{args.port}", flush=True)
    app.serve(host=args.server_name, port=args.port)
    return 0


def segment_align(args) -> int:
    from everyvoice_tpu_torch.models.aligner.segment import align_long_audio

    device = _device()
    try:
        align_long_audio(args.audio, args.transcript, args.output, device=device,
                         acoustic_model=str(args.acoustic_model) if args.acoustic_model else None)
    except (RuntimeError, FileNotFoundError) as e:
        raise CLIError(str(e)) from None
    print(f"Wrote {args.output}")
    return 0


def segment_extract(args) -> int:
    from everyvoice_tpu_torch.models.aligner.segment import extract_segments, parse_textgrid

    _device()  # the cutting is host work; the segment verbs take the device rule alike
    segments = parse_textgrid(args.textgrid)
    if not segments:
        raise CLIError(f"No non-empty intervals found in {args.textgrid}")
    rows = extract_segments(args.audio, segments, args.output_dir, prefix=args.prefix)
    print(f"Wrote {len(rows)} segments to {args.output_dir}/wavs and "
          f"{args.output_dir}/metadata.psv")
    return 0


# ---------------------------------------------------------------------------
# the parser


class _Diagnostic(argparse.Action):
    def __init__(self, option_strings, dest, **kwargs):
        super().__init__(option_strings, dest, nargs=0, **kwargs)

    def __call__(self, parser, namespace, values, option_string=None):
        import importlib.metadata
        import platform

        print(f"EveryVoice-TPU version: {VERSION} (PyTorch package)")
        print(f"Python version: {platform.python_version()}")
        print(f"Platform: {platform.platform()}")
        print("Dependencies:")
        for package in ("torch", "triton", "numpy", "scipy"):
            try:
                print(f"  {package}=={importlib.metadata.version(package)}")
            except importlib.metadata.PackageNotFoundError:
                print(f"  {package}: not installed")
        import torch

        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        if torch.cuda.is_available():
            names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
            print(f"CUDA cards: {torch.cuda.device_count()} {names}")
        else:
            print("CUDA cards: none")
        parser.exit(0)


def _existing(text: str) -> Path:
    path = Path(text)
    if not path.exists():
        raise argparse.ArgumentTypeError(f"Path '{text}' does not exist.")
    return path


def _common_train_options(p) -> None:
    p.add_argument("config_path", type=_existing)
    p.add_argument("-c", "--config-args", action="append", default=[],
                   help="key.path=value config overrides")
    p.add_argument("-a", "--accelerator", default="auto", choices=("auto", "tpu", "cpu", "gpu"),
                   help="auto and gpu: the CUDA card; cpu: the CPU")
    p.add_argument("-d", "--devices", default="auto",
                   help="Devices per node, one worker process each: 'auto' every visible "
                   "card (one CPU rank with -a cpu), or a count (gloo ranks with -a cpu).")
    p.add_argument("-n", "--nodes", default=1, type=int,
                   help="Nodes (hosts) running this command; node rank and rank 0's address "
                   "from EVERYVOICE_NODE_RANK/NODE_RANK and EVERYVOICE_COORDINATOR_ADDRESS "
                   "or MASTER_ADDR:MASTER_PORT.")
    p.add_argument("-s", "--strategy", default="ddp",
                   help="'ddp'/'auto' (data parallel, the default), 'fsdp' (ZeRO-3 parameter "
                   "and optimizer-state sharding), or 'tp<k>'/'ddp_tp<k>' (k-way tensor "
                   "parallelism of FastSpeech2's Conformer; the vocoders and StyleTTS2 stay "
                   "replicated).")
    p.add_argument("--gradient-clip-val", default=None, type=float)
    p.add_argument("--profile-steps", default=0, type=int,
                   help="Capture a torch.profiler trace of the first N steps into the run dir.")
    p.add_argument("--steps-per-execution", default=1, type=int)
    p.add_argument("--compute-precision", default="auto", choices=("auto", "float32", "bfloat16"),
                   help="'auto' = bfloat16 on a card, float32 on the CPU")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=PROG, description="EveryVoice-TPU's PyTorch/CUDA package: text-to-speech on "
        "a CUDA card.")
    parser.add_argument("--version", action="version", version=f"{PROG}, version {VERSION}")
    parser.add_argument("--diagnostic", action=_Diagnostic,
                        help="Print versions of this package, its dependencies and the cards.")
    verbs = parser.add_subparsers(dest="verb", metavar="COMMAND", required=True)

    # The pipeline verbs first, the rest alphabetically (MainCommandOrder).
    p = verbs.add_parser("new-project", help="Create a new project with a guided wizard.")
    p.add_argument("-r", "--resume-from", type=_existing, default=None,
                   help="Resume a saved wizard session.")
    p.add_argument("--trace", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--debug-state", action="store_true", help=argparse.SUPPRESS)
    p.set_defaults(run=new_project)

    p = verbs.add_parser("preprocess", help="Preprocess a dataset.")
    p.add_argument("model_kind", choices=("text-to-spec", "spec-to-wav", "text-to-wav"))
    p.add_argument("config_path", type=_existing)
    p.add_argument("-s", "--steps", action="append", choices=STEPS,
                   help="Steps to run (default: all relevant for the model kind; 'ood' "
                   "stages out-of-domain text for StyleTTS2).")
    p.add_argument("-O", "--overwrite", action="store_true",
                   help="Redo all preprocessing even when artifacts exist.")
    p.add_argument("-C", "--cpus", default=1, type=int, help="Host workers for audio IO.")
    p.add_argument("-D", "--debug", action="store_true", help="Enable debug logging.")
    p.add_argument("--device-audio", action="store_true",
                   help="Gate the loudness, resample and peak-normalize the audio step's "
                   "clips as bucket-padded batches on the card (int16 both ways where the "
                   "effects keep the 16-bit grid); decoding, effects and writes stay on the "
                   "host.")
    p.add_argument("-c", "--config-args", action="append", default=[],
                   help="key.path=value config overrides")
    p.set_defaults(run=preprocess)

    p = verbs.add_parser("train", help="Train a model.")
    kinds = p.add_subparsers(dest="model_kind", metavar="MODEL", required=True)
    for kind, what in (("text-to-spec", "Train a FastSpeech2 feature-prediction model."),
                       ("spec-to-wav", "Train a HiFiGAN (or iSTFTNet) vocoder."),
                       ("text-to-wav", "Train a StyleTTS2 end-to-end model (two stages).")):
        k = kinds.add_parser(kind, help=what)
        _common_train_options(k)
        if kind == "text-to-wav":
            k.add_argument("--mode", choices=("first", "second"), default="first",
                           help="first: acoustic pretraining; second: joint training with "
                           "the style diffusion, from the first stage's checkpoint.")
        k.set_defaults(run=train)

    p = verbs.add_parser("synthesize", help="Synthesize speech from text or spectrograms.")
    kinds = p.add_subparsers(dest="kind", metavar="MODE", required=True)
    k = kinds.add_parser("from-text", help="Text → mel (→ wav with a vocoder).")
    k.add_argument("model_path", type=_existing)
    k.add_argument("-t", "--text", action="append", help="Text(s) to synthesize.")
    k.add_argument("-f", "--filelist", type=_existing, default=None)
    k.add_argument("-l", "--language", default=None)
    k.add_argument("-s", "--speaker", default=None)
    k.add_argument("-D", "--duration-control", default=1.0, type=float)
    k.add_argument("-O", "--output-type", dest="output_types", action="append",
                   choices=OUTPUT_TYPES)
    k.add_argument("--vocoder-path", "--model", dest="vocoder_path", type=_existing, default=None)
    k.add_argument("-o", "--output-dir", type=Path, default=Path("synthesis_output"))
    k.add_argument("--teacher-forcing-directory", type=Path, default=None)
    k.add_argument("--style-reference", type=_existing, default=None,
                   help="Reference wav for GST style conditioning.")
    k.set_defaults(run=synthesize_from_text)
    k = kinds.add_parser("text-to-wav", help="Text → wav end to end with a StyleTTS2 "
                         "checkpoint.")
    k.add_argument("model_path", type=_existing)
    k.add_argument("-t", "--text", action="append", help="Text(s) to synthesize.")
    k.add_argument("-f", "--filelist", type=_existing, default=None)
    k.add_argument("-l", "--language", default=None)
    k.add_argument("-r", "--reference", type=_existing, default=None,
                   help="Reference wav whose encoded style sets the speaker identity "
                   "(blended with the diffusion-sampled style).")
    k.add_argument("--diffusion-steps", default=5, type=int)
    k.add_argument("--embedding-scale", default=1.0, type=float,
                   help="Classifier-free guidance scale for the style diffusion.")
    k.add_argument("--acoustic-blend", default=0.5, type=float,
                   help="0=all reference acoustic style, 1=all sampled.")
    k.add_argument("--prosody-blend", default=0.5, type=float,
                   help="0=all reference prosodic style, 1=all sampled.")
    k.add_argument("--seed", default=0, type=int,
                   help="Seeds the style diffusion's noise (a torch.Generator's).")
    k.add_argument("-O", "--output-type", dest="output_types", action="append", choices=("wav",),
                   help="StyleTTS2 is end-to-end; wav is the only output type.")
    k.add_argument("-o", "--output-dir", type=Path, default=Path("synthesis_output"))
    k.set_defaults(run=synthesize_text_to_wav)
    k = kinds.add_parser("from-spec", help="Mel spectrogram files → wav (vocoder only).")
    k.add_argument("model_path", type=_existing)
    k.add_argument("-i", "--input-dir", type=_existing,
                   default=Path("synthesis_output/synthesized_spec"))
    k.add_argument("-o", "--output-dir", type=Path, default=Path("synthesis_output"))
    k.set_defaults(run=synthesize_from_spec)

    p = verbs.add_parser("check", help="Data and configuration checks.")
    kinds = p.add_subparsers(dest="kind", metavar="CHECK", required=True)
    k = kinds.add_parser("text-config",
                         help="Report symbols found in the data but missing from the config.")
    k.add_argument("config_path", type=_existing)
    k.add_argument("-f", "--filelist", type=_existing, required=True)
    k.set_defaults(run=check_text_config)
    k = kinds.add_parser("pretrained-symbols",
                         help="Compare config symbols with the frozen pretrained symbol table.")
    k.add_argument("config_path", type=_existing)
    k.set_defaults(run=check_pretrained_symbols)
    k = kinds.add_parser("data", help="Score every item's losses with a trained model.")
    k.add_argument("config_path", type=_existing)
    k.add_argument("--model-path", type=_existing, required=True,
                   help="A (partially) trained FastSpeech2 checkpoint.")
    k.add_argument("-o", "--output", type=Path, default=Path("checked-data.json"))
    k.set_defaults(run=check_data)

    p = verbs.add_parser("checkpoint", help="Inspect or edit checkpoints.")
    kinds = p.add_subparsers(dest="kind", metavar="ACTION", required=True)
    k = kinds.add_parser("inspect", help="Print checkpoint metadata, config and parameters.")
    k.add_argument("checkpoint_path", type=_existing)
    k.add_argument("--show-config", dest="show_config", action="store_true", default=True)
    k.add_argument("--no-show-config", dest="show_config", action="store_false")
    k.add_argument("--show-architecture", action="store_true")
    k.set_defaults(run=checkpoint_inspect)
    k = kinds.add_parser("rename-speaker", help="Rename a speaker in speaker2id.")
    k.add_argument("checkpoint_path", type=_existing)
    k.add_argument("old_name")
    k.add_argument("new_name")
    k.add_argument("output_path", type=Path)
    k.set_defaults(run=checkpoint_rename_speaker)

    p = verbs.add_parser("demo", help="Serve an interactive synthesis demo over HTTP (the model "
                         "type is read from the checkpoint).")
    p.add_argument("model_path", type=_existing)
    p.add_argument("-V", "--vocoder", "--vocoder-path", dest="vocoder_path", type=_existing,
                   default=None, help="[FastSpeech2] Trained vocoder checkpoint; required when "
                   "MODEL_PATH is a FastSpeech2 model.")
    p.add_argument("-s", "--speaker", dest="speakers", action="append", default=[],
                   help="[FastSpeech2] Speaker to expose (repeat; default: every speaker).")
    p.add_argument("-l", "--language", dest="languages", action="append", default=[],
                   help="Language to expose (repeat; default: every language).")
    p.add_argument("-O", "--output-format", dest="output_formats", action="append", default=[],
                   choices=("all",) + OUTPUT_TYPES,
                   help="[FastSpeech2] Output format to expose (repeat; default: all).")
    p.add_argument("-o", "--output-dir", type=Path, default=Path("synthesis_output"),
                   help="Directory where the demo writes synthesized files.")
    p.add_argument("-R", "--ref-speaker", dest="ref_speakers", action="append", default=[],
                   help="[StyleTTS2] Named reference speaker as 'Display "
                   "Name=path/to/audio.wav' (repeat); styles are precomputed at startup.")
    p.add_argument("-r", "--reference", type=_existing, default=None,
                   help="[StyleTTS2] Default reference audio that sets the initial style.")
    p.add_argument("-p", "--port", default=7860, type=int)
    p.add_argument("-n", "--server-name", default="0.0.0.0",
                   help="Host/IP address to bind the demo server to.")
    p.add_argument("-a", "--accelerator", default="auto", choices=("auto", "tpu", "cpu", "gpu"),
                   help="auto and gpu: the CUDA card; cpu: the CPU")
    p.add_argument("--share", action="store_true",
                   help="(Unsupported) there is no tunnel service.")
    p.add_argument("--allowlist", type=Path, default=None,
                   help="Text file of allowed words (one per line); everything else is "
                   "rejected. Mutually exclusive with --denylist.")
    p.add_argument("--denylist", type=Path, default=None,
                   help="Text file of disallowed words (one per line).")
    p.add_argument("--ref-audio-dir", type=Path, default=None,
                   help="[StyleTTS2] Directory of reference speaker wavs (each *.wav becomes "
                   "a named speaker).")
    p.add_argument("--ui-config", type=_existing, default=None,
                   help="JSON with UI label overrides; 'speakers'/'languages' entries restrict "
                   "the dropdowns to their keys and rename them to their values.")
    p.set_defaults(run=demo)

    p = verbs.add_parser("evaluate", help="Objective evaluation of synthesized wavs.")
    p.add_argument("wav_dir", metavar="WAV_DIR_OR_FILE", nargs="?", type=_existing, default=None)
    p.add_argument("-f", "--audio-file", type=_existing, default=None)
    p.add_argument("-d", "--audio-directory", type=_existing, default=None)
    p.add_argument("-g", "--reference-dir", type=_existing, default=None,
                   help="Ground-truth wavs (same filenames) for intrusive metrics.")
    p.add_argument("-r", "--non-matching-reference", "-n", "--non-matching-references",
                   dest="non_matching_references", type=_existing, default=None)
    p.add_argument("-o", "--output", type=Path, default=Path("evaluation.json"))
    p.set_defaults(run=evaluate)

    p = verbs.add_parser("export", help="Export models for serving.")
    kinds = p.add_subparsers(dest="kind", metavar="MODEL", required=True)
    k = kinds.add_parser("spec-to-wav", help="Strip discriminators and optimizer state.")
    k.add_argument("model_path", type=_existing)
    k.add_argument("output_path", type=Path)
    k.set_defaults(run=export_spec_to_wav)

    p = verbs.add_parser("fetch-pretrained",
                         help="Download StyleTTS2's pretrained components (not ported).")
    p.add_argument("model_kind", choices=("text-to-spec", "spec-to-wav", "text-to-wav"))
    p.add_argument("--config-path", type=_existing, default=None)
    p.add_argument("--output-dir", type=Path, default=None)
    p.set_defaults(run=fetch_pretrained)

    p = verbs.add_parser("g2p", help="Convert text to phones with the G2P engine for LANG_ID.")
    p.add_argument("lang_id")
    p.add_argument("text")
    p.set_defaults(run=g2p)

    p = verbs.add_parser("segment", help="Align and segment long audio with a CTC aligner.")
    kinds = p.add_subparsers(dest="kind", metavar="ACTION", required=True)
    k = kinds.add_parser("align", help="CTC-align a transcript against long audio, producing a "
                         "TextGrid.")
    k.add_argument("audio", type=_existing)
    k.add_argument("transcript", type=_existing)
    k.add_argument("-o", "--output", type=Path, default=Path("alignment.TextGrid"))
    k.add_argument("--acoustic-model", type=_existing, default=None,
                   help="Locally staged wav2vec2-CTC model directory (default: "
                   "$EVERYVOICE_WAV2VEC2_PATH), scored on the card.")
    k.set_defaults(run=segment_align)
    k = kinds.add_parser("extract", help="Cut a TextGrid's intervals out of long audio into "
                         "per-segment wavs plus a metadata filelist.")
    k.add_argument("audio", type=_existing)
    k.add_argument("textgrid", type=_existing)
    k.add_argument("-o", "--output-dir", type=Path, default=Path("segments"))
    k.add_argument("--prefix", default="segment")
    k.set_defaults(run=segment_extract)
    return parser


def main(argv=None) -> int:
    """Run one command; returns its exit code (argparse exits 2 on a usage
    error)."""
    import logging

    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    try:
        return args.run(args)
    except CLIError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
