"""Plain-dict views of a checkpoint header's ``hyper_parameters.config``.

The JAX package validates these dicts with pydantic models
(``models/fs2/config.py``, ``models/hifigan/config.py``,
``config/preprocessing_config.py``, ``config/text_config.py``); the port has
no pydantic, so it fills in the same defaults here and reads plain dicts.
The defaults cover the model section of each model's config, the audio and
text sections they share, and the preprocessing section with its datasets.
"""

from __future__ import annotations

import copy

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
