"""Project config files, loaded as the JAX package's pydantic loaders load
them, into the plain dicts the port's entry points take.

    from everyvoice_tpu_torch.config_files import load_config_from_path
    config = load_config_from_path("text-to-spec", "config/everyvoice-text-to-spec.yaml",
                                   overrides=["training.max_steps=20"])

``kind`` is ``text-to-spec`` (FastSpeech2), ``spec-to-wav`` (HiFiGAN),
``text-to-wav`` (StyleTTS2) or ``preprocessing`` (a shared data config). A
``.json`` file reads as JSON, anything else as YAML. The steps are those of
``PartialLoadConfig.load_config_from_path`` and ``update_config``:

1. each ``path_to_<key>_config_file`` of the kind's partial keys is loaded
   (relative to the file's directory) and merged under ``<key>``
   shallowly: an inline ``<key>`` section's keys replace the partial's
   whole values;
2. a ``VERSION`` whose major part is above 1 raises;
3. the path fields (datasets' ``data_dir`` and ``filelist``,
   ``preprocessing.save_dir``, ``training.logger.save_dir``,
   ``finetune_checkpoint``, the training and validation filelists and
   ``training.vocoder_path``) resolve against the top-level file's
   directory, the partials' paths too;
4. the defaults are filled in (``config.fs2_training_config``,
   ``hifigan_training_config``, ``styletts2_config``,
   ``preprocessing_config``), then the
   ``-c key.path=value`` overrides merge in (an integer part indexes a
   list), and the whole is checked again;
5. a key that is not a field of its section raises, naming it, as
   ``extra="forbid"`` does; so do a missing ``contact``, a malformed
   contact e-mail, a dataset without ``permissions_obtained`` and both
   ``ckpt_steps`` and ``ckpt_epochs``. ``preprocessing.save_dir`` is
   created.

The result equals the JAX loader's ``model_dump(mode="json")``, with one
difference: the JAX package leaves a relative ``training.vocoder_path`` to
the working directory, where the port resolves it against the config
file's directory as it does every other path.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Sequence

from everyvoice_tpu_torch.config import (
    AUDIO,
    CONFORMER,
    DATASET,
    FS2_MODEL,
    FS2_TRAINING,
    HIFIGAN_MODEL,
    HIFIGAN_TRAINING,
    LOGGER,
    OPTIMIZERS,
    PREPROCESSING,
    PUNCTUATION,
    ST2_DECODER,
    ST2_DIFFUSION,
    ST2_DIFFUSION_DIST,
    ST2_DIFFUSION_TRANSFORMER,
    ST2_LOSSES,
    ST2_MODEL,
    ST2_OOD_HF,
    ST2_OOD_SOURCE,
    ST2_OPTIMIZER,
    ST2_PRETRAINED,
    ST2_PRETRAINED_ASR,
    ST2_PRETRAINED_F0,
    ST2_PRETRAINED_PLBERT,
    ST2_SLM,
    ST2_SLMADV,
    ST2_TRAINING,
    TEXT,
    VARIANCE_PREDICTOR,
    apply_overrides,
    fs2_training_config,
    hifigan_training_config,
    merge_defaults,
    preprocessing_config,
    styletts2_config,
)
from everyvoice_tpu_torch.utils import load_config_file

KINDS = ("text-to-spec", "spec-to-wav", "text-to-wav", "preprocessing")
PARTIAL_KEYS = {
    "text-to-spec": ("model", "training", "preprocessing", "text"),
    "spec-to-wav": ("model", "training", "preprocessing"),
    "text-to-wav": ("model", "training", "preprocessing", "text"),
    "preprocessing": ("audio",),
}
FILL = {"text-to-spec": fs2_training_config, "spec-to-wav": hifigan_training_config,
        "text-to-wav": styletts2_config}
CONTACT_FIELDS = {"contact_name": None, "contact_email": None}
EMAIL = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")
BOUNDARIES = {"strong": "!?.", "weak": ":;,"}
PREPROCESSING_SECTION = {**PREPROCESSING, "VERSION": "1.0", "audio": AUDIO,
                         "path_to_audio_config_file": None, "source_data": []}


def _top(partials: tuple) -> dict:
    out = {"contact": CONTACT_FIELDS, "VERSION": "1.0"}
    for key in partials:
        out[key] = None
        out[f"path_to_{key}_config_file"] = None
    return out


# The fields of every section the JAX package validates with
# ``extra="forbid"``, by the section's path ("*" is every list item); each
# key set equals its pydantic class's ``model_fields``.
SCHEMA = {
    "text-to-spec": {
        (): _top(PARTIAL_KEYS["text-to-spec"]),
        ("contact",): CONTACT_FIELDS,
        ("model",): FS2_MODEL,
        ("model", "encoder"): CONFORMER,
        ("model", "decoder"): CONFORMER,
        ("model", "variance_predictors"): FS2_MODEL["variance_predictors"],
        ("model", "variance_predictors", "energy"): {**VARIANCE_PREDICTOR, "level": "phone"},
        ("model", "variance_predictors", "duration"): VARIANCE_PREDICTOR,
        ("model", "variance_predictors", "pitch"): {**VARIANCE_PREDICTOR, "level": "phone"},
        ("training",): FS2_TRAINING,
        ("training", "logger"): LOGGER,
        ("preprocessing",): PREPROCESSING_SECTION,
        ("preprocessing", "audio"): AUDIO,
        ("preprocessing", "source_data", "*"): DATASET,
        ("text",): TEXT,
    },
    "spec-to-wav": {
        (): _top(PARTIAL_KEYS["spec-to-wav"]),
        ("contact",): CONTACT_FIELDS,
        ("model",): HIFIGAN_MODEL,
        ("training",): HIFIGAN_TRAINING,
        ("training", "logger"): LOGGER,
        ("preprocessing",): PREPROCESSING_SECTION,
        ("preprocessing", "audio"): AUDIO,
        ("preprocessing", "source_data", "*"): DATASET,
    },
    "text-to-wav": {
        (): {**_top(PARTIAL_KEYS["text-to-wav"]), "pretrained": None},
        ("contact",): CONTACT_FIELDS,
        ("model",): ST2_MODEL,
        ("model", "decoder"): ST2_DECODER,
        ("model", "slm"): ST2_SLM,
        ("model", "diffusion"): ST2_DIFFUSION,
        ("model", "diffusion", "transformer"): ST2_DIFFUSION_TRANSFORMER,
        ("model", "diffusion", "dist"): ST2_DIFFUSION_DIST,
        ("training",): ST2_TRAINING,
        ("training", "logger"): LOGGER,
        ("training", "optimizer"): ST2_OPTIMIZER,
        ("training", "losses"): ST2_LOSSES,
        ("training", "slmadv"): ST2_SLMADV,
        ("training", "ood_raw_data", "*"): ST2_OOD_SOURCE,
        ("training", "ood_raw_data", "*", "hf"): ST2_OOD_HF,
        ("preprocessing",): PREPROCESSING_SECTION,
        ("preprocessing", "audio"): AUDIO,
        ("preprocessing", "source_data", "*"): DATASET,
        ("text",): TEXT,
        ("pretrained",): ST2_PRETRAINED,
        ("pretrained", "f0"): ST2_PRETRAINED_F0,
        ("pretrained", "asr"): ST2_PRETRAINED_ASR,
        ("pretrained", "plbert"): ST2_PRETRAINED_PLBERT,
    },
    "preprocessing": {
        ("preprocessing",): PREPROCESSING_SECTION,
        ("preprocessing", "audio"): AUDIO,
        ("preprocessing", "source_data", "*"): DATASET,
    },
}
# Fields that hold a path resolved against the config file's directory.
RELATIVE_PATHS = (
    (("preprocessing", "source_data", "*"), "data_dir"),
    (("preprocessing", "source_data", "*"), "filelist"),
    (("preprocessing",), "save_dir"),
    (("training", "logger"), "save_dir"),
    (("training",), "finetune_checkpoint"),
    (("training",), "training_filelist"),
    (("training",), "validation_filelist"),
    (("training",), "vocoder_path"),
)
# Fields that name a function, written as the JAX package writes them.
CALLABLES = (
    (("preprocessing", "source_data", "*"), "filelist_loader"),
    (("training",), "filelist_loader"),
    (("training", "logger"), "sub_dir_callable"),
    (("model",), "activation_function"),
    (("model", "decoder"), "activation_function"),
)


class ConfigError(ValueError):
    """A config file that the JAX package's loader refuses too."""


def _sections(tree, path: tuple, at: tuple = ()):
    """(location, node) of every node of ``tree`` at ``path``; "*" is each
    item of a list or each value of a mapping."""
    if not path:
        yield at, tree
        return
    head, rest = path[0], path[1:]
    if head == "*":
        items = (enumerate(tree) if isinstance(tree, list)
                 else tree.items() if isinstance(tree, dict) else ())
        for key, child in items:
            yield from _sections(child, rest, at + (str(key),))
    elif isinstance(tree, dict) and isinstance(tree.get(head), (dict, list)):
        yield from _sections(tree[head], rest, at + (head,))


def _check_version(section: dict, where: str) -> None:
    version = section.get("VERSION")
    if version is None:
        return
    if not isinstance(version, str):
        raise ConfigError(f"{where}VERSION must be a string, not {version!r}")
    try:
        major = int(version.split(".")[0])
    except ValueError:
        raise ConfigError(f"Invalid VERSION '{version}'") from None
    if major > 1:
        raise ConfigError(
            f"Your config is version {version} but this version of everyvoice_tpu "
            "only supports major version 1. Please upgrade."
        )


def load_partials(data: dict, partial_keys: Sequence[str], base_dir: Path) -> dict:
    """Each ``path_to_<key>_config_file`` loaded and merged under ``<key>``,
    the inline section's keys over the partial's (one level deep)."""
    for key in partial_keys:
        path_key = f"path_to_{key}_config_file"
        if not data.get(path_key):
            continue
        partial_path = Path(data[path_key])
        if not partial_path.is_absolute():
            partial_path = (base_dir / partial_path).resolve()
        if not partial_path.exists():
            raise ConfigError(
                f"Partial config file '{partial_path}' (from {path_key}) does not exist")
        partial = load_config_file(partial_path)
        inline = data.get(key)
        if isinstance(inline, dict):
            merged = dict(partial)
            merged.update(inline)
            data[key] = merged
        else:
            data[key] = partial
    return data


def _resolve_paths(config: dict, base_dir) -> None:
    """Every path field as a string, resolved against ``base_dir`` (None:
    only normalized, as ``Path`` normalizes it)."""
    for section, field in RELATIVE_PATHS:
        for _, node in _sections(config, section):
            if not isinstance(node, dict) or node.get(field) is None:
                continue
            path = Path(node[field])
            if base_dir is not None and not path.is_absolute():
                path = (Path(base_dir) / path).resolve()
            node[field] = str(path)


def _callable_name(name):
    """A function's name as the JAX package writes it back: a bare name is
    in ``everyvoice_tpu.utils``, ``everyvoice.`` means ``everyvoice_tpu.``."""
    if not isinstance(name, str):
        return name
    if "." not in name:
        return f"everyvoice_tpu.utils.{name}"
    if name.startswith("everyvoice."):
        return "everyvoice_tpu." + name[len("everyvoice."):]
    return name


def _text_section(given) -> dict:
    """A text section with its defaults, as ``TextConfig`` validates it:
    punctuation classes it does not know dropped, boundaries filled in,
    global replacements sorted longest key first, every declared symbol
    normalized by the cleaners and replacements that apply to it."""
    from everyvoice_tpu_torch.text.text_processor import (
        get_label_from_symbol_key,
        normalize_text_helper,
    )
    from everyvoice_tpu_torch.utils import resolve_cleaner

    text = merge_defaults(TEXT, given)
    for key in ("cleaners",):
        text[key] = [_callable_name(c) for c in text[key]]
    for key in ("language_cleaners", "dataset_cleaners"):
        text[key] = {k: [_callable_name(c) for c in v] for k, v in text[key].items()}
    text["to_replace"] = dict(sorted(text["to_replace"].items(), key=lambda kv: len(kv[0]),
                                     reverse=True))
    text["boundaries"] = {k: merge_defaults(BOUNDARIES, {b: v[b] for b in BOUNDARIES if b in v})
                          for k, v in text["boundaries"].items()}
    symbols = text["symbols"]
    symbols["punctuation"] = {k: symbols["punctuation"][k] for k in PUNCTUATION}
    for key, values in symbols.items():
        if key != "punctuation" and not (
                isinstance(values, list) and all(isinstance(v, str) for v in values)):
            raise ConfigError(f"{key} must be a list of strings")
    for key, values in list(symbols.items()):
        if key in ("punctuation", "silence"):
            continue
        label = get_label_from_symbol_key(key)
        cleaners = text["dataset_cleaners"].get(label, text["cleaners"])
        to_replace = text["dataset_to_replace"].get(label, text["to_replace"])
        cleaners = [resolve_cleaner(c) for c in cleaners]
        symbols[key] = [s for s in (normalize_text_helper(v, to_replace, cleaners)
                                    for v in values) if s]
    punctuation = {s for v in symbols["punctuation"].values() for s in v}
    others = {s for k, v in symbols.items() if k != "punctuation" for s in v}
    if punctuation & others:
        raise ConfigError(
            f"Symbol(s) {sorted(punctuation & others)} occur in both your punctuation and "
            "your other symbol sets; please remove the duplicates.")
    return text


def _check_extra(config: dict, kind: str) -> None:
    for section, fields in SCHEMA[kind].items():
        for at, node in _sections(config, section):
            if not isinstance(node, dict):
                continue
            extra = sorted(set(node) - set(fields), key=str)
            if extra:
                where = ".".join(at) or "the top level"
                raise ConfigError(
                    f"Extra inputs are not permitted: {', '.join(map(str, extra))} "
                    f"(in {where}); check the spelling against the schema")
    optimizer = (config.get("training") or {}).get("optimizer")
    if isinstance(optimizer, dict) and kind != "text-to-wav":
        fields = OPTIMIZERS.get(optimizer.get("name"), {})
        extra = sorted(set(optimizer) - set(fields))
        if extra:
            raise ConfigError(f"Extra inputs are not permitted: {', '.join(extra)} "
                              "(in training.optimizer)")


def _check_contact(config: dict) -> None:
    contact = config.get("contact")
    if not isinstance(contact, dict):
        raise ConfigError("contact must be a mapping of contact_name and contact_email")
    for field in CONTACT_FIELDS:
        if not isinstance(contact.get(field), str):
            raise ConfigError(f"contact.{field} is required")
    if not EMAIL.match(contact["contact_email"]):
        raise ConfigError(
            f"contact.contact_email {contact['contact_email']!r} is not an e-mail address")


def _check_training(training: dict) -> None:
    if training["ckpt_steps"] is not None and training["ckpt_epochs"] is not None:
        raise ConfigError("ckpt_steps and ckpt_epochs are mutually exclusive; set one to null.")
    for name in ("ckpt_steps", "ckpt_epochs"):
        if training[name] is not None and training[name] < 0:
            raise ConfigError(f"{name} must be a non-negative integer, got {training[name]}")
    if training.get("attn_bin_loss_warmup_epochs", 1) < 1:
        raise ConfigError("attn_bin_loss_warmup_epochs must be at least 1")


def _validate(config: dict, kind: str) -> dict:
    """The config with its defaults filled in and every check made."""
    config = copy.deepcopy(config)
    _check_version(config, "")
    _check_version(config.get("preprocessing") or {}, "preprocessing.")
    _check_extra(config, kind)
    for section, field in CALLABLES:
        for _, node in _sections(config, section):
            if isinstance(node, dict) and not node.get(field):
                node.pop(field, None)  # a falsy name takes the default
    try:
        if kind == "preprocessing":
            out = preprocessing_config(config)
            out["preprocessing"] = merge_defaults(PREPROCESSING_SECTION, out["preprocessing"])
        else:
            _check_contact(config)
            out = FILL[kind](config)
            _check_training(out["training"])
    except ConfigError:
        raise
    except (ValueError, TypeError, KeyError) as e:
        raise ConfigError(str(e)) from None
    pre = out["preprocessing"]
    if not 0.0 <= pre["train_split"] <= 1.0:
        raise ConfigError(f"train_split must be between 0 and 1, got {pre['train_split']}")
    for section, field in CALLABLES:
        for _, node in _sections(out, section):
            if isinstance(node, dict) and field in node:
                node[field] = _callable_name(node[field])
    if "text" in PARTIAL_KEYS[kind]:
        out["text"] = _text_section(out["text"])
    return out


def load_config_from_path(kind: str, path: Path | str, overrides: Sequence[str] = ()) -> dict:
    """The ``kind`` config in the file at ``path`` with its partials, its
    paths resolved, its defaults and the ``-c`` ``overrides``: the dict
    ``fs2_training_config``, ``hifigan_training_config``,
    ``styletts2_config`` or ``preprocessing_config`` returns. Raises ``ConfigError`` where the JAX
    package's loader raises."""
    if kind not in KINDS:
        raise ValueError(f"Unknown config kind {kind!r}: expected one of {KINDS}")
    path = Path(path)
    if not path.exists():
        raise ConfigError(f"Config file '{path}' does not exist")
    data = load_config_file(path)
    if not isinstance(data, dict):
        raise ConfigError(f"Config file '{path}' did not contain a mapping")
    base_dir = path.parent
    data = load_partials(data, PARTIAL_KEYS[kind], base_dir)
    if kind == "preprocessing":
        data = {"preprocessing": data}
    elif "contact" not in data:
        raise ConfigError(
            "EveryVoice models require contact information; please add a "
            "'contact' section (contact_name, contact_email)."
        )
    _resolve_paths(data, base_dir)
    config = _validate(data, kind)
    if overrides:
        try:
            config = apply_overrides(config, overrides)
        except (ValueError, IndexError, TypeError) as e:
            raise ConfigError(f"-c {', '.join(overrides)}: {e}") from None
        config = _validate(config, kind)
        _resolve_paths(config, None)
    Path(config["preprocessing"]["save_dir"]).mkdir(parents=True, exist_ok=True)
    return config


def load_text_config_from_path(path: Path | str) -> dict:
    """A text config file (the wizard's ``everyvoice-shared-text``) with its
    defaults, as ``TextConfig.load_config_from_path`` validates it."""
    data = load_config_file(path)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ConfigError(f"Config file '{path}' did not contain a mapping")
    extra = sorted(set(data) - set(TEXT))
    if extra:
        raise ConfigError(f"Extra inputs are not permitted: {', '.join(extra)} (in the text config)")
    return _text_section(data)
