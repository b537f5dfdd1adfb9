"""Plain-dict views of a checkpoint header's ``hyper_parameters.config``.

The JAX package validates these dicts with pydantic models
(``models/fs2/config.py``, ``models/hifigan/config.py``,
``config/preprocessing_config.py``, ``config/text_config.py``); the port has
no pydantic, so it fills in the same defaults here and reads plain dicts.
The defaults cover the model section of each model's config, the audio and
text sections they share, the preprocessing section with its datasets, and
the training sections of FastSpeech2 and HiFiGAN with their optimizer and
logger (``fs2_training_config`` and ``hifigan_training_config``, whose
``model_checkpoint_dump`` is the JAX package's
``FastSpeech2Config``/``HiFiGANConfig.model_checkpoint_dump``).
``styletts2_config`` fills a whole StyleTTS2 config
(``models/styletts2/config.py``'s ``StyleTTS2Config``): model, training,
preprocessing, text and the pretrained components' section.
"""

from __future__ import annotations

import copy
import json
import math

CONFORMER = {
    "layers": 4, "heads": 2, "input_dim": 256, "feedforward_dim": 1024,
    "conv_kernel_size": 9, "dropout": 0.2,
}
VARIANCE_PREDICTOR = {
    "loss": "mse", "n_layers": 5, "kernel_size": 3, "dropout": 0.5,
    "input_dim": 256, "n_bins": 256, "depthwise": True,
}
FS2_MODEL = {
    "encoder": CONFORMER,
    "decoder": CONFORMER,
    "variance_predictors": {
        "energy": {**VARIANCE_PREDICTOR, "level": "phone"},
        "duration": VARIANCE_PREDICTOR,
        "pitch": {**VARIANCE_PREDICTOR, "level": "phone"},
    },
    "target_text_representation_level": "characters",
    "learn_alignment": True,
    "use_global_style_token_module": False,
    "max_length": 1000,
    "mel_loss": "mse",
    "use_postnet": True,
    "multilingual": False,
    "multispeaker": False,
}
HIFIGAN_MODEL = {
    "resblock": "1",
    "upsample_rates": [8, 8, 2, 2],
    "upsample_kernel_sizes": [16, 16, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "activation_function": "everyvoice_tpu.utils.original_hifigan_leaky_relu",
    "istft_layer": False,
    "msd_layers": 3,
    "mpd_layers": [2, 3, 5, 7, 11],
}
AUDIO = {
    "min_audio_length": 0.4, "max_audio_length": 11.0,
    "max_wav_value": 32767.0, "input_sampling_rate": 22050,
    "output_sampling_rate": 22050, "alignment_sampling_rate": 22050,
    "target_bit_depth": 16, "n_fft": 1024, "fft_window_size": 1024,
    "fft_hop_size": 256, "f_min": 0, "f_max": 8000, "n_mels": 80,
    "spec_type": "mel-librosa", "vocoder_segment_size": 8192,
}
PREPROCESSING = {
    "dataset": "YourDataSet",
    "train_split": 0.9,
    "dataset_split_seed": 1234,
    "save_dir": "preprocessed/YourDataSet",
}
DATASET = {
    "label": "YourDataSet",
    "permissions_obtained": False,
    "data_dir": "/please/create/a/path/to/your/dataset/data",
    "filelist": "/please/create/a/path/to/your/dataset/filelist",
    "filelist_loader": "everyvoice_tpu.utils.generic_psv_filelist_reader",
    "sox_effects": [["channels", "1"]],
}
PUNCTUATION = {
    "exclamations": ["!", "¡"],
    "question_symbols": ["?", "¿"],
    "quotemarks": ['"', "'", "“", "”", "«", "»"],
    "parentheses": ["(", ")", "[", "]", "{", "}"],
    "periods": ["."],
    "colons": [":"],
    "semi_colons": [";"],
    "hyphens": ["-", "—", "*"],
    "commas": [","],
    "ellipses": ["…"],
}
TEXT = {
    "symbols": {"silence": ["<SIL>"], "punctuation": PUNCTUATION},
    "to_replace": {},
    "language_to_replace": {},
    "dataset_to_replace": {},
    "cleaners": [
        "everyvoice_tpu.utils.collapse_whitespace",
        "everyvoice_tpu.utils.strip_text",
    ],
    "language_cleaners": {},
    "dataset_cleaners": {},
    "g2p_engines": {},
    "split_text": True,
    "boundaries": {},
}


def merge_defaults(defaults: dict, given: dict | None) -> dict:
    """``given`` over a deep copy of ``defaults``: nested dicts merge key by
    key, everything else in ``given`` replaces the default."""
    out = copy.deepcopy(defaults)
    for key, value in (given or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merge_defaults(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _preprocessing(config: dict) -> dict:
    pre = dict(config.get("preprocessing") or {})
    pre["audio"] = merge_defaults(AUDIO, pre.get("audio"))
    return pre


def fs2_config(config: dict) -> dict:
    """A FastSpeech2 checkpoint's config with the defaults filled in."""
    return {
        **config,
        "model": merge_defaults(FS2_MODEL, config.get("model")),
        "preprocessing": _preprocessing(config),
        "text": merge_defaults(TEXT, config.get("text")),
    }


def hifigan_config(config: dict) -> dict:
    """A HiFiGAN checkpoint's config with the defaults filled in."""
    return {
        **config,
        "model": merge_defaults(HIFIGAN_MODEL, config.get("model")),
        "preprocessing": _preprocessing(config),
    }


def preprocessing_config(config: dict) -> dict:
    """A config for preprocessing, with the defaults of its preprocessing
    section, of each dataset in ``source_data`` and of its text section
    filled in. Raises, as the JAX package's validator does, for a dataset
    without ``permissions_obtained``."""
    pre = merge_defaults(PREPROCESSING, config.get("preprocessing"))
    pre["audio"] = merge_defaults(AUDIO, pre.get("audio"))
    datasets = []
    for given in pre.get("source_data") or []:
        dataset = merge_defaults(DATASET, given)
        if not dataset["filelist_loader"]:
            dataset["filelist_loader"] = DATASET["filelist_loader"]
        if not dataset["permissions_obtained"]:
            raise ValueError(
                "You must check off that you have permission to use your data "
                "(set permissions_obtained: true)."
            )
        datasets.append(dataset)
    pre["source_data"] = datasets
    return {**config, "preprocessing": pre, "text": merge_defaults(TEXT, config.get("text"))}


# Optimizer defaults by name (config/shared_types.py:236-259).
OPTIMIZERS = {
    "adam": {"learning_rate": 1e-4, "eps": 1e-8, "weight_decay": 0.01,
             "betas": [0.9, 0.98], "name": "adam"},
    "adamw": {"learning_rate": 1e-4, "eps": 1e-8, "weight_decay": 0.01,
              "betas": [0.9, 0.98], "name": "adamw"},
    "rms": {"learning_rate": 1e-4, "eps": 1e-8, "weight_decay": 0.01,
            "alpha": 0.99, "name": "rms"},
    "noam": {"learning_rate": 1e-4, "eps": 1e-8, "weight_decay": 0.01,
             "betas": [0.9, 0.98], "name": "noam", "warmup_steps": 1000},
}
FS2_OPTIMIZER = {**OPTIMIZERS["noam"], "learning_rate": 1e-3, "weight_decay": 1e-6,
                 "betas": [0.9, 0.999]}
LOGGER = {
    "name": "BaseExperiment",
    "save_dir": "logs_and_checkpoints",
    "sub_dir_callable": "everyvoice_tpu.utils.get_current_time",
    "version": "base",
}
# BaseTrainingConfig (config/shared_types.py:262-302), in the JAX package's
# field order.
BASE_TRAINING = {
    "batch_size": 16,
    "save_top_k_ckpts": 5,
    "ckpt_steps": None,
    "ckpt_epochs": 1,
    "val_check_interval": 500,
    "check_val_every_n_epoch": None,
    "max_epochs": 1000,
    "max_steps": 100000,
    "finetune_checkpoint": None,
    "training_filelist": "path/to/your/preprocessed/training_filelist.psv",
    "validation_filelist": "path/to/your/preprocessed/validation_filelist.psv",
    "filelist_loader": "everyvoice_tpu.utils.generic_psv_filelist_reader",
    "logger": LOGGER,
    "val_data_workers": 0,
    "train_data_workers": 4,
}
# With FastSpeech2's fields (models/fs2/config.py:106-129).
FS2_TRAINING = {
    **BASE_TRAINING,
    "use_weighted_sampler": False,
    "optimizer": FS2_OPTIMIZER,
    "vocoder_path": None,
    "mel_loss_weight": 1.0,
    "postnet_loss_weight": 1.0,
    "pitch_loss_weight": 0.1,
    "energy_loss_weight": 0.1,
    "duration_loss_weight": 0.1,
    "attn_ctc_loss_weight": 0.1,
    "attn_bin_loss_weight": 0.1,
    "attn_bin_loss_warmup_epochs": 100,
}
# With HiFiGAN's fields (models/hifigan/config.py:78-96).
HIFIGAN_TRAINING = {
    **BASE_TRAINING,
    "generator_warmup_steps": 0,
    "gan_type": "original",
    "optimizer": OPTIMIZERS["adamw"],
    "wgan_clip_value": 0.01,
    "use_weighted_sampler": False,
    "finetune": False,
}
# StyleTTS2 (models/styletts2/config.py). The decoder section's
# upsample_initial_channel and resblock fields are not read by the model:
# StyleTTS2Module.from_config passes the decoder none of them.
ST2_DECODER = {
    "resblock": "1",
    "upsample_rates": [8, 8],
    "upsample_kernel_sizes": [16, 16],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "activation_function": "everyvoice_tpu.utils.original_hifigan_leaky_relu",
    "istft_layer": True,
    "msd_layers": 3,
    "mpd_layers": [2, 3, 5, 7, 11],
    "gen_istft_n_fft": 16,
    "gen_istft_hop_size": 4,
}
ST2_SLM = {"model": "microsoft/wavlm-base-plus", "sr": 16000, "hidden": 768, "nlayers": 13,
           "initial_channel": 64}
ST2_DIFFUSION_TRANSFORMER = {"num_layers": 3, "num_heads": 8, "head_features": 64,
                             "multiplier": 2}
ST2_DIFFUSION_DIST = {"sigma_data": 0.2, "estimate_sigma_data": True, "mean": -3.0, "std": 1.0}
ST2_DIFFUSION = {"embedding_mask_proba": 0.1, "transformer": ST2_DIFFUSION_TRANSFORMER,
                 "dist": ST2_DIFFUSION_DIST}
ST2_MODEL = {
    "multispeaker": False,
    "multilingual": False,
    "language_embedding_dim": 64,
    "target_text_representation_level": "characters",
    "dim_in": 64,
    "hidden_dim": 512,
    "max_conv_dim": 512,
    "n_layer": 3,
    "max_dur": 50,
    "style_dim": 128,
    "dropout": 0.2,
    "decoder": ST2_DECODER,
    "slm": ST2_SLM,
    "diffusion": ST2_DIFFUSION,
}
ST2_OPTIMIZER = {"lr": 1e-4, "bert_lr": 1e-5, "ft_lr": 1e-5}
ST2_LOSSES = {
    "lambda_mel": 5.0, "lambda_gen": 1.0, "lambda_slm": 1.0, "lambda_mono": 1.0,
    "lambda_s2s": 1.0, "tma_epoch": 50, "lambda_f0": 1.0, "lambda_norm": 1.0,
    "lambda_dur": 1.0, "lambda_ce": 20.0, "lambda_sty": 1.0, "lambda_diff": 1.0,
    "diff_epoch": 20, "joint_epoch": 50,
}
ST2_SLMADV = {"min_len": 100, "max_len": 500, "batch_percentage": 0.5, "iter": 10,
              "thresh": 5.0, "scale": 0.01, "sig": 1.5}
ST2_OOD_HF = {"repo_id": None, "filename": "ood.txt", "revision": None}
ST2_OOD_SOURCE = {"local_path": None, "hf": None, "text_representation": "characters"}
ST2_TRAINING = {
    **BASE_TRAINING,
    "batch_size": 2,
    "save_top_k_ckpts": 1,
    "epochs_1st": 200,
    "epochs_2nd": 100,
    "max_len": 800,
    "decoder_segment_frames": 320,
    "first_stage_path": "checkpoints/stage-1-last.ckpt",
    "second_stage_load_pretrained": True,
    "load_only_params": False,
    "root_path": ".",
    "ood_raw_data": {},
    "use_validation_as_ood": False,
    "OOD_min_length": 50,
    "optimizer": ST2_OPTIMIZER,
    "losses": ST2_LOSSES,
    "slmadv": ST2_SLMADV,
}
# The frozen 178-symbol table of the published pretrained components
# (PL-BERT, the ASR aligner): a symbol's index is its embedding row.
PRETRAINED_SYMBOL_TABLE = (
    ["$"]
    + list(';:,.!?¡¿—…"«»“” ')
    + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
    + list(
        "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧ"
        "ʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
    )
)
ST2_PRETRAINED_F0 = {"repo_id": "everyvoice/styletts2-jdc-f0", "filename": "bst.t7",
                     "local_path": None}
ST2_PRETRAINED_ASR = {"repo_id": "everyvoice/styletts2-asr-aligner",
                      "checkpoint_filename": "epoch_00080.pth", "config_filename": "config.yml",
                      "local_checkpoint": None, "local_config": None}
ST2_PRETRAINED_PLBERT = {"repo_id": "papercup-ai/multilingual-pl-bert",
                         "checkpoint_filename": "step_1100000.t7",
                         "config_filename": "config.yml", "local_checkpoint": None,
                         "local_config": None}
ST2_PRETRAINED = {"f0": ST2_PRETRAINED_F0, "asr": ST2_PRETRAINED_ASR,
                  "plbert": ST2_PRETRAINED_PLBERT,
                  "pretrained_symbols": PRETRAINED_SYMBOL_TABLE}
# Path-typed fields: the JAX package's checkpoint dump drops a Path value
# (a None stays). (section keys, field) pairs; "*" is every item of a list
# or every value of a mapping.
PATH_FIELDS = (
    ((), "path_to_model_config_file"), ((), "path_to_training_config_file"),
    ((), "path_to_preprocessing_config_file"), ((), "path_to_text_config_file"),
    (("training",), "finetune_checkpoint"), (("training",), "training_filelist"),
    (("training",), "validation_filelist"), (("training",), "vocoder_path"),
    (("training", "logger"), "save_dir"),
    (("preprocessing",), "save_dir"), (("preprocessing",), "path_to_audio_config_file"),
    (("preprocessing", "source_data", "*"), "data_dir"),
    (("preprocessing", "source_data", "*"), "filelist"),
    (("training",), "first_stage_path"), (("training",), "root_path"),
    (("training", "ood_raw_data", "*"), "local_path"),
    (("pretrained", "f0"), "local_path"),
    (("pretrained", "asr"), "local_checkpoint"), (("pretrained", "asr"), "local_config"),
    (("pretrained", "plbert"), "local_checkpoint"), (("pretrained", "plbert"), "local_config"),
)


def optimizer_config(given: dict | None, default: dict = FS2_OPTIMIZER) -> dict:
    """An optimizer section: ``default`` (FastSpeech2's Noam) when none is
    given, else the given fields over the defaults of the optimizer it names,
    ``default``'s by default (a given section is validated from its class's
    defaults)."""
    if given is None:
        return copy.deepcopy(default)
    name = given.get("name", default["name"])
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}: expected one of {sorted(OPTIMIZERS)}")
    return merge_defaults(OPTIMIZERS[name], given)


def fs2_training_config(config: dict) -> dict:
    """A FastSpeech2 training config with every default of the JAX
    package's ``FastSpeech2Config`` filled in: model, training (optimizer,
    logger), preprocessing (audio, datasets) and text. Raises where that
    validator does: no ``contact``, or a dataset without permission."""
    if "contact" not in config:
        raise ValueError(
            "EveryVoice models require contact information; please add a "
            "'contact' section (contact_name, contact_email)."
        )
    pre = preprocessing_config(config)
    training = merge_defaults(FS2_TRAINING, config.get("training"))
    training["optimizer"] = optimizer_config((config.get("training") or {}).get("optimizer"))
    out = {"VERSION": "1.0", **config}
    for key in ("model", "training", "preprocessing", "text"):
        out.setdefault(f"path_to_{key}_config_file", None)
    out["model"] = merge_defaults(FS2_MODEL, config.get("model"))
    out["training"] = training
    out["preprocessing"] = {"VERSION": "1.0", "path_to_audio_config_file": None,
                            **pre["preprocessing"]}
    out["text"] = pre["text"]
    return out


def hifigan_training_config(config: dict) -> dict:
    """A HiFiGAN training config with every default of the JAX package's
    ``HiFiGANConfig`` filled in: model, training (AdamW, logger) and
    preprocessing (audio, datasets). Raises where that validator does: no
    ``contact``, a dataset without permission, or upsampling rates whose
    product is not the hop (or, with the iSTFT head, does not divide it)."""
    if "contact" not in config:
        raise ValueError(
            "EveryVoice models require contact information; please add a "
            "'contact' section (contact_name, contact_email)."
        )
    pre = preprocessing_config(config)["preprocessing"]
    training = merge_defaults(HIFIGAN_TRAINING, config.get("training"))
    training["optimizer"] = optimizer_config((config.get("training") or {}).get("optimizer"),
                                             OPTIMIZERS["adamw"])
    out = {"VERSION": "1.0", **config}
    for key in ("model", "training", "preprocessing"):
        out.setdefault(f"path_to_{key}_config_file", None)
    out.pop("text", None)
    out["model"] = merge_defaults(HIFIGAN_MODEL, config.get("model"))
    out["training"] = training
    out["preprocessing"] = {"VERSION": "1.0", "path_to_audio_config_file": None, **pre}
    product = math.prod(out["model"]["upsample_rates"])
    hop = pre["audio"]["fft_hop_size"]
    if out["model"]["istft_layer"]:
        if hop % product != 0:
            raise ValueError(f"With istft_layer, prod(upsample_rates)={product} must "
                             f"divide fft_hop_size={hop}.")
    elif product != hop:
        raise ValueError(f"prod(upsample_rates)={product} must equal fft_hop_size={hop}.")
    return out


def styletts2_config(config: dict) -> dict:
    """A StyleTTS2 config (a checkpoint header's or a project file's) with
    every default of the JAX package's ``StyleTTS2Config`` filled in:
    model, training (optimizer, losses, SLM-adversarial settings, each
    out-of-domain text source), preprocessing (audio, datasets), text and
    the pretrained components. Raises where that validator does: no
    ``contact``, or a dataset without permission."""
    if "contact" not in config:
        raise ValueError(
            "EveryVoice models require contact information; please add a "
            "'contact' section (contact_name, contact_email)."
        )
    pre = preprocessing_config(config)
    model = merge_defaults(ST2_MODEL, config.get("model"))
    if not model["decoder"]["activation_function"]:
        model["decoder"]["activation_function"] = ST2_DECODER["activation_function"]
    training = merge_defaults(ST2_TRAINING, config.get("training"))
    for label, source in training["ood_raw_data"].items():
        source = merge_defaults(ST2_OOD_SOURCE, source)
        if source["hf"] is not None:
            source["hf"] = merge_defaults(ST2_OOD_HF, source["hf"])
        training["ood_raw_data"][label] = source
    out = {"VERSION": "1.0", **config}
    for key in ("model", "training", "preprocessing", "text"):
        out.setdefault(f"path_to_{key}_config_file", None)
    out["model"] = model
    out["training"] = training
    out["preprocessing"] = {"VERSION": "1.0", "path_to_audio_config_file": None,
                            **pre["preprocessing"]}
    out["text"] = pre["text"]
    out["pretrained"] = merge_defaults(ST2_PRETRAINED, config.get("pretrained"))
    return out


def _drop_paths(node, section: tuple, field: str):
    if not section:
        if isinstance(node, dict) and node.get(field) is not None:
            node.pop(field)
        return
    head, rest = section[0], section[1:]
    if head == "*":
        children = node.values() if isinstance(node, dict) else node
    else:
        children = [node.get(head)] if isinstance(node, dict) else []
    for child in children or []:
        _drop_paths(child, rest, field)


def model_checkpoint_dump(config: dict) -> dict:
    """The config as the JAX package writes it into a checkpoint header and
    ``hparams.yaml``: JSON types, every path-typed field that holds a path
    dropped (a checkpoint crosses machines)."""
    out = json.loads(json.dumps(config))
    for section, field in PATH_FIELDS:
        _drop_paths(out, section, field)
    return out


def combine_configs(orig, new: dict):
    """``new`` merged into ``orig``: mappings recursively, an integer key
    indexing a list (the JAX package's ``combine_configs``)."""
    if isinstance(orig, list):
        out = list(orig)
        for key, value in new.items():
            idx = int(key)
            out[idx] = combine_configs(out[idx], value) if isinstance(value, dict) else value
        return out
    out = dict(orig) if isinstance(orig, dict) else {}
    for key, value in new.items():
        if isinstance(value, dict) and isinstance(out.get(key), (dict, list)):
            out[key] = combine_configs(out[key], value)
        else:
            out[key] = value
    return out


def apply_overrides(config: dict, overrides) -> dict:
    """``key.path=value`` overrides (the CLI's ``-c``) merged into
    ``config`` one after another, as the JAX package's
    ``update_config_from_cli_args`` merges them, the values coerced as its
    CLI coerces them."""
    for arg in overrides or ():
        if "=" not in arg:
            raise ValueError(f"Invalid config override '{arg}'; expected key.path=value")
        key, _, value = arg.partition("=")
        nested = _coerce_override(value)
        for part in reversed(key.split(".")):
            nested = {part: nested}
        config = combine_configs(config, nested)
    return config


def _coerce_override(value: str):
    text = value.strip()
    if text.lower() in ("true", "false"):
        return text.lower() == "true"
    if text.lower() in ("null", "none", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    if text.startswith(("[", "{")):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            pass
    return value
