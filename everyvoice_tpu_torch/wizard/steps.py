"""The wizard's steps (counterpart of everyvoice_tpu/wizard/steps.py): the
project's basics, the subtour of each dataset (filelist format sniffing,
header mapping, speaker and language columns, the ISO language picker, wav
validation, text processing, automatic symbol discovery, audio effects),
the out-of-domain text sources, the config format, and
``write_config_package``, which writes the five config files and the
filelists with the port's ``write_config_file`` (YAML by
``utils/yaml_lite.py``) and ``write_filelist``.

For the same answers it writes the JAX wizard's project: the same filelists
byte for byte, and config files that load to the same dicts. A step that
would need the network only records what it was given: the ``hf:`` OOD
source keeps the repository's name.
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

from everyvoice_tpu_torch.wizard.tour import Step

logger = logging.getLogger(__name__)

CONFIG_STEMS = {
    "text": "everyvoice-shared-text",
    "data": "everyvoice-shared-data",
    "text-to-spec": "everyvoice-text-to-spec",
    "spec-to-wav": "everyvoice-spec-to-wav",
    "text-to-wav": "everyvoice-text-to-wav",
}
CONFIG_FILES = {k: f"{stem}.yaml" for k, stem in CONFIG_STEMS.items()}

# Headers the pipeline understands; anything else becomes unknown_<i>.
STANDARD_HEADERS = (
    "basename", "raw_text", "speaker", "language",
    "characters", "phones", "arpabet",
)
TEXT_HEADERS = ("text", "characters", "phones", "arpabet")

YES_NO = ("no", "yes")


def _is_yes(response) -> bool:
    return str(response).strip().lower() in ("yes", "y", "true")


class NameStep(Step):
    DEFAULT_NAME = "Name Step"

    def __init__(self, **kwargs):
        super().__init__(
            prompt_text="What would you like to call this project?", **kwargs
        )

    def validate(self, response) -> bool:
        return bool(response) and bool(re.match(r"^[\w\s\-]+$", str(response)))

    def effect(self):
        self.state["name"] = str(self.response).strip()


class ContactNameStep(Step):
    DEFAULT_NAME = "Contact Name Step"

    def __init__(self, **kwargs):
        super().__init__(prompt_text="What is your full name?", **kwargs)

    def validate(self, response) -> bool:
        return bool(str(response).strip()) and len(str(response).strip()) > 2

    def effect(self):
        self.state["contact_name"] = str(self.response).strip()


class ContactEmailStep(Step):
    DEFAULT_NAME = "Contact Email Step"

    def __init__(self, **kwargs):
        super().__init__(prompt_text="What is your email address?", **kwargs)

    def validate(self, response) -> bool:
        return bool(re.match(r"^[^@\s]+@[^@\s]+\.[^@\s]+$", str(response).strip()))

    def effect(self):
        self.state["contact_email"] = str(self.response).strip()


class OutputPathStep(Step):
    DEFAULT_NAME = "Output Path Step"

    def __init__(self, **kwargs):
        super().__init__(
            prompt_text="Where should the new project be created?",
            default=".", **kwargs,
        )

    def sanitize_input(self, response):
        return str(response).strip()

    def validate(self, response) -> bool:
        path = Path(str(response)).expanduser()
        if path.exists() and not path.is_dir():
            return False
        return True

    def effect(self):
        self.state["output_path"] = Path(str(self.response)).expanduser()


# ---------------------------------------------------------------------------
# dataset subtour


class DatasetStep(Step):
    """Base for per-dataset steps: provides the dataset state dict."""

    def __init__(self, dataset_index: int = 0, name: str | None = None, **kwargs):
        self.dataset_index = dataset_index
        super().__init__(
            name=name or f"{self.DEFAULT_NAME} {dataset_index}", **kwargs
        )

    @property
    def dataset(self) -> dict:
        datasets = self.state.setdefault("datasets", [])
        while len(datasets) <= self.dataset_index:
            datasets.append({})
        return datasets[self.dataset_index]


class FilelistStep(DatasetStep):
    DEFAULT_NAME = "Filelist Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Where is your data filelist?", **kwargs,
        )

    def sanitize_input(self, response):
        return str(response).strip()

    def validate(self, response) -> bool:
        return Path(str(response)).expanduser().is_file()

    def effect(self):
        self.dataset["filelist"] = Path(str(self.response)).expanduser()


class PermissionsStep(DatasetStep):
    DEFAULT_NAME = "Dataset Permission Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "Do you have permission from the speaker(s) to use this data "
                "to build a text-to-speech model? (yes/no)"
            ),
            **kwargs,
        )

    def validate(self, response) -> bool:
        return str(response).strip().lower() in (
            "yes", "y", "true", "no", "n", "false",
        )

    def effect(self):
        if not _is_yes(self.response):
            raise SystemExit(
                "You must have permission to use your data; the wizard cannot "
                "continue without it."
            )
        self.dataset["permissions_obtained"] = True


class FilelistFormatStep(DatasetStep):
    """Pick/confirm the filelist format (psv/tsv/csv/festival), parse it,
    and queue header-mapping follow-ups for any missing standard columns."""

    DEFAULT_NAME = "Filelist Format Step"
    SEPARATORS = {"psv": "|", "tsv": "\t", "csv": ","}
    CHOICES = ["psv", "tsv", "csv", "festival"]

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Select which format your filelist is in:",
            default="psv", **kwargs,
        )

    def looks_like_choice(self):
        return self.CHOICES

    def _read_tabular(self, delimiter: str, limit: int | None = None) -> list:
        import csv

        path = self.dataset["filelist"]
        rows = []
        with open(path, newline="", encoding="utf8") as f:
            # Same dialect as the project's own filelist readers/writers
            # (utils.generic_xsv_filelist_reader: no quoting, backslash
            # escapes) so a filelist this framework wrote — including
            # escaped delimiters inside text — survives the wizard round
            # trip.
            for record in csv.reader(
                f, delimiter=delimiter, quoting=csv.QUOTE_NONE,
                escapechar="\\",
            ):
                rows.append(record)
                if limit is not None and len(rows) >= limit:
                    break
        return rows

    def validate(self, response) -> bool:
        response = str(response)
        if response not in self.CHOICES:
            return False
        if response == "festival":
            from everyvoice_tpu_torch.utils import read_festival

            try:
                read_festival(self.dataset["filelist"], record_limit=10)
                return True
            except Exception:
                logger.warning(
                    f"{self.dataset['filelist']} does not parse as festival."
                )
                return False
        sample = self._read_tabular(self.SEPARATORS[response], limit=10)
        if not sample:
            raise SystemExit(
                f"Filelist {self.dataset['filelist']} is empty — nothing to "
                "build a project from."
            )
        width = len(sample[0])
        if width < 2:
            logger.warning(
                f"No {response} record separator found on the first line of "
                f"{self.dataset['filelist']}."
            )
            return False
        if any(len(record) != width for record in sample):
            logger.warning(
                f"Rows of {self.dataset['filelist']} have inconsistent field "
                f"counts for the {response} format."
            )
            return False
        return True

    def effect(self):
        ds = self.dataset
        fmt = str(self.response)
        ds["format"] = fmt
        if fmt == "festival":
            from everyvoice_tpu_torch.utils import read_festival

            ds["delimiter"] = None
            ds["rows"] = read_festival(ds["filelist"])
            ds["headers"] = list(ds["rows"][0].keys())
            ds["selected"] = list(range(len(ds["headers"])))
            return
        ds["delimiter"] = self.SEPARATORS[fmt]
        ds["data_list"] = self._read_tabular(ds["delimiter"])
        ds["headers"] = list(ds["data_list"][0])
        ds["selected"] = []
        follow_ups = []
        found_standard = False
        if any(h in ds["headers"] for h in TEXT_HEADERS):
            for i, header in enumerate(ds["headers"]):
                if header in TEXT_HEADERS:
                    ds["selected"].append(i)
            found_standard = True
        else:
            follow_ups.append(
                HeaderStep(
                    self.dataset_index, header_name="text",
                    prompt_text="Which column contains the text?",
                    name=f"Text Header Step {self.dataset_index}",
                )
            )
        if "basename" in ds["headers"]:
            ds["selected"].append(ds["headers"].index("basename"))
            found_standard = True
        else:
            follow_ups.append(
                HeaderStep(
                    self.dataset_index, header_name="basename",
                    prompt_text="Which column contains the basenames (audio "
                    "file names without the .wav extension)?",
                    name=f"Basename Header Step {self.dataset_index}",
                )
            )
        if not found_standard:
            follow_ups.insert(0, HasHeaderLineStep(self.dataset_index))
        if follow_ups:
            assert self.tour is not None
            self.tour.add_steps_right_after(follow_ups, self)


class HasHeaderLineStep(DatasetStep):
    """When no standard header was recognized, ask whether row 0 is a
    header; if not, duplicate it so row 0 can keep acting as one."""

    DEFAULT_NAME = "Data Has Header Line Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(dataset_index, default="yes", **kwargs)

    def prompt(self):
        first = self.dataset["data_list"][0]
        self.prompt_text = (
            "Your filelist does not use the standard column names. Its first "
            f"row is:\n  {(self.dataset['delimiter'] or '|').join(first)}\n"
            "Is that row a header row? (yes/no)"
        )
        return super().prompt()

    def looks_like_choice(self):
        return list(YES_NO)

    def validate(self, response) -> bool:
        return str(response).strip().lower() in YES_NO + ("y", "n")

    def effect(self):
        if not _is_yes(self.response):
            logger.info("Treating the first row as a record, not a header.")
            self.dataset["data_list"].insert(0, self.dataset["data_list"][0])


class HeaderStep(DatasetStep):
    """Pick which (not-yet-assigned) column plays a standard role."""

    DEFAULT_NAME = "Header Step"

    def __init__(self, dataset_index: int = 0, header_name: str = "text",
                 **kwargs):
        self.header_name = header_name
        super().__init__(dataset_index, **kwargs)

    def _available(self) -> list:
        ds = self.dataset
        return [
            i for i in range(len(ds["headers"]))
            if i not in ds.get("selected", [])
        ]

    def looks_like_choice(self):
        ds = self.dataset
        return [
            f"{i}: {ds['data_list'][0][i]}" for i in self._available()
        ]

    def run(self):
        # Auto-select a column already named for the role (e.g. a literal
        # 'speaker' column) instead of asking.
        ds = self.dataset
        if self.header_name in ds["headers"]:
            idx = ds["headers"].index(self.header_name)
            if idx in self._available():
                self.response = idx
                self.completed = True
                self._finish(idx)
                return
        super().run()

    def sanitize_input(self, response):
        # Accept a bare index, a "<i>: <name>" menu answer, or a column name.
        text = str(response).strip()
        match = re.match(r"^(\d+)", text)
        if match:
            return int(match.group(1))
        ds = self.dataset
        if text in ds["headers"]:
            return ds["headers"].index(text)
        return response

    def validate(self, response) -> bool:
        return isinstance(response, int) and response in self._available()

    def effect(self):
        self._finish(int(self.response))

    def _finish(self, index: int):
        ds = self.dataset
        ds.setdefault("selected", []).append(index)
        ds["headers"][index] = self.header_name
        self._after_assign()

    def _after_assign(self):
        """Hook for subclasses that finalize parsing after assignment."""


class LanguageHeaderStep(HeaderStep):
    """Language column selection is the last header decision, so it also
    finalizes parsing."""

    DEFAULT_NAME = "Language Header Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        kwargs.setdefault("header_name", "language")
        super().__init__(dataset_index, **kwargs)

    def _after_assign(self):
        _finalize_filelist_rows(self.dataset)


class TextRepresentationStep(DatasetStep):
    DEFAULT_NAME = "Filelist Text Representation Step"
    CHOICES = ["characters", "phones", "arpabet"]

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "Which representation is your text in? Pick 'phones' for "
                "pure IPA text, 'arpabet' for ARPABET, 'characters' "
                "otherwise (punctuation is fine in all three)."
            ),
            default="characters", **kwargs,
        )

    def looks_like_choice(self):
        return self.CHOICES

    def validate(self, response) -> bool:
        return str(response) in self.CHOICES

    def effect(self):
        ds = self.dataset
        rep = str(self.response)
        ds["text_representation"] = rep
        # A generic 'text' column now means the chosen representation.
        for i, header in enumerate(ds.get("headers", [])):
            if header == "text":
                ds["headers"][i] = rep
        for row in ds.get("rows", []) or []:
            if "text" in row:
                row[rep] = row.pop("text")


class TextProcessingStep(DatasetStep):
    """Pick extra per-dataset cleaners; global default cleaners always
    apply."""

    DEFAULT_NAME = "Text Processing Step"
    CHOICES = ["none", "lowercase", "nfc normalization",
               "lowercase + nfc normalization"]
    CLEANER_NAMES = {
        "lowercase": ["everyvoice_tpu.utils.lower"],
        "nfc normalization": ["everyvoice_tpu.utils.nfc_normalize"],
        "lowercase + nfc normalization": [
            "everyvoice_tpu.utils.lower",
            "everyvoice_tpu.utils.nfc_normalize",
        ],
    }

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "Which text transformations should apply to this dataset's "
                "text?"
            ),
            default="none", **kwargs,
        )

    def looks_like_choice(self):
        return self.CHOICES

    def validate(self, response) -> bool:
        return str(response) in self.CHOICES

    def effect(self):
        from everyvoice_tpu_torch.utils import (
            collapse_whitespace,
            lower,
            nfc_normalize,
            strip_text,
        )

        ds = self.dataset
        ds["cleaners"] = self.CLEANER_NAMES.get(str(self.response), [])
        fns = [collapse_whitespace, strip_text]
        if "lowercase" in str(self.response):
            fns.append(lower)
        if "nfc" in str(self.response):
            fns.append(nfc_normalize)
        text_cols = [
            i for i, h in enumerate(ds.get("headers", []))
            if h in TEXT_HEADERS
        ]
        for record in ds.get("data_list", [])[1:]:
            for i in text_cols:
                if i < len(record):
                    for fn in fns:
                        record[i] = fn(record[i])
        for row in ds.get("rows", []) or []:
            for key in TEXT_HEADERS:
                if key in row:
                    for fn in fns:
                        row[key] = fn(row[key])


class HasSpeakerStep(DatasetStep):
    DEFAULT_NAME = "Data Has Speaker Value Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Does your data have a column/value for the speaker? "
            "(yes/no)",
            default="no", **kwargs,
        )

    def looks_like_choice(self):
        return list(YES_NO)

    def run(self):
        if not _has_columns_left(self.dataset):
            self.response = "no"
            self.completed = True
            self.effect()
            return
        super().run()

    def validate(self, response) -> bool:
        return str(response).strip().lower() in YES_NO + ("y", "n")

    def effect(self):
        assert self.tour is not None
        if _is_yes(self.response):
            self.tour.add_steps_right_after(
                [HeaderStep(
                    self.dataset_index, header_name="speaker",
                    prompt_text="Which column contains the speaker?",
                    name=f"Speaker Header Step {self.dataset_index}",
                )],
                self,
            )
        else:
            self.tour.add_steps_right_after(
                [KnowSpeakerStep(self.dataset_index)], self
            )


class KnowSpeakerStep(DatasetStep):
    DEFAULT_NAME = "Know Speaker Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "With no speaker column we will use the default speaker ID "
                "'speaker_{i}'. Would you like to pick a different ID for "
                "this dataset? (yes/no)"
            ),
            default="no", **kwargs,
        )

    def looks_like_choice(self):
        return list(YES_NO)

    def validate(self, response) -> bool:
        return str(response).strip().lower() in YES_NO + ("y", "n")

    def effect(self):
        assert self.tour is not None
        if _is_yes(self.response):
            self.tour.add_steps_right_after(
                [AddSpeakerStep(self.dataset_index)], self
            )
        else:
            self.dataset["speaker_id"] = f"speaker_{self.dataset_index}"


class AddSpeakerStep(DatasetStep):
    DEFAULT_NAME = "Add Speaker Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Enter the speaker ID to use for this dataset:",
            **kwargs,
        )

    def validate(self, response) -> bool:
        from everyvoice_tpu_torch.utils import slugify

        text = str(response).strip()
        return bool(text) and slugify(text) == text

    def effect(self):
        self.dataset["speaker_id"] = str(self.response).strip()


class HasLanguageStep(DatasetStep):
    DEFAULT_NAME = "Data Has Language Value Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Does your data have a column/value for the language? "
            "(yes/no)",
            default="no", **kwargs,
        )

    def looks_like_choice(self):
        return list(YES_NO)

    def run(self):
        if not _has_columns_left(self.dataset):
            self.response = "no"
            self.completed = True
            self.effect()
            return
        super().run()

    def validate(self, response) -> bool:
        return str(response).strip().lower() in YES_NO + ("y", "n")

    def effect(self):
        assert self.tour is not None
        if _is_yes(self.response):
            self.tour.add_steps_right_after(
                [LanguageHeaderStep(
                    self.dataset_index,
                    prompt_text="Which column contains the language?",
                    name=f"Language Header Step {self.dataset_index}",
                )],
                self,
            )
        else:
            self.tour.add_steps_right_after(
                [SelectLanguageStep(self.dataset_index)], self
            )


class SelectLanguageStep(DatasetStep):
    """ISO language picker over the registered G2P languages, with und /
    custom escape hatches."""

    DEFAULT_NAME = "Select Language Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "Which language is this dataset in? (Datasets with several "
                "languages need a language column instead.)"
            ),
            default="und", **kwargs,
        )

    def looks_like_choice(self):
        from everyvoice_tpu_torch.text.phonemizer import (
            AVAILABLE_G2P_ENGINES,
            G2P_LANGUAGE_NAMES,
        )

        return [
            "[und]: my language isn't here, use the default mapping",
            "[custom]: my language isn't here, I will provide a code",
        ] + [
            f"[{code}]: {G2P_LANGUAGE_NAMES.get(code, 'Unknown')}"
            for code in sorted(AVAILABLE_G2P_ENGINES)
        ]

    def sanitize_input(self, response):
        # Accept "[eng]: English" menu answers or a bare code.
        match = re.search(r"\[([\w-]+)\]", str(response))
        return match.group(1) if match else str(response).strip()

    def validate(self, response) -> bool:
        return bool(re.match(r"^[\w-]+$", str(response)))

    def effect(self):
        code = str(self.response)
        if code == "custom":
            assert self.tour is not None
            self.tour.add_steps_right_after(
                [LanguageCodeStep(self.dataset_index)], self
            )
            return
        self.dataset["language"] = code
        _finalize_filelist_rows(self.dataset)


class LanguageCodeStep(DatasetStep):
    DEFAULT_NAME = "Language Code Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Enter the language code for this dataset's language:",
            **kwargs,
        )

    def sanitize_input(self, response):
        return str(response).strip()

    def validate(self, response) -> bool:
        from everyvoice_tpu_torch.utils import slugify

        return bool(response) and slugify(str(response)) == str(response)

    def effect(self):
        self.dataset["language"] = str(self.response)
        _finalize_filelist_rows(self.dataset)


class CustomG2PStep(DatasetStep):
    """Per-language custom G2P configuration loop: keep the current engines
    or set one, which re-queues this menu."""

    DEFAULT_NAME = "Custom G2P Step"
    KEEP = "Keep the current g2p settings and continue"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "By default text is mapped to IPA phones with the built-in "
                "G2P engines; you may register custom G2P functions per "
                "language instead."
            ),
            default=self.KEEP, **kwargs,
        )

    def _languages(self) -> list:
        ds = self.dataset
        langs = {row.get("language", "und") for row in ds.get("rows", []) or []}
        if ds.get("language"):
            langs.add(ds["language"])
        return sorted(langs)

    def looks_like_choice(self):
        custom = self.state.get("custom_g2p", {})
        options = [self.KEEP]
        for lang in self._languages():
            current = custom.get(lang, f"default mapping for '{lang}'")
            options.append(f"[{lang}] set a custom g2p engine (current: {current})")
        return options

    def sanitize_input(self, response):
        text = str(response).strip()
        if text in ("", self.KEEP, "keep"):
            return self.KEEP
        match = re.match(r"^\[?([\w-]+)\]?", text)
        return match.group(1) if match else text

    def validate(self, response) -> bool:
        return response == self.KEEP or response in self._languages()

    def effect(self):
        if self.response == self.KEEP:
            return
        assert self.tour is not None
        self.tour.add_steps_right_after(
            [
                SelectG2PEngineStep(self.dataset_index, language=self.response),
                CustomG2PStep(
                    self.dataset_index,
                    name=f"Custom G2P Step {self.dataset_index} "
                    f"(after {self.response})",
                ),
            ],
            self,
        )


class SelectG2PEngineStep(DatasetStep):
    DEFAULT_NAME = "Select G2P Engine Step"

    def __init__(self, dataset_index: int = 0, language: str = "und", **kwargs):
        self.language = language
        kwargs.setdefault("name", f"Select G2P Engine Step {dataset_index} "
                          f"[{language}]")
        super().__init__(
            dataset_index,
            prompt_text=(
                f"Enter the fully qualified Python name of your G2P function "
                f"for '{language}' (e.g. mymodule.submodule.my_g2p):"
            ),
            **kwargs,
        )

    def sanitize_input(self, response):
        return str(response).strip()

    def validate(self, response) -> bool:
        from everyvoice_tpu_torch.text.phonemizer import load_custom_g2p_engine

        try:
            load_custom_g2p_engine(self.language, str(response))
            return True
        except Exception as e:
            logger.warning(f"G2P function '{response}' failed validation: {e}")
            return False

    def effect(self):
        self.state.setdefault("custom_g2p", {})[self.language] = str(
            self.response
        )


class WavsDirStep(DatasetStep):
    DEFAULT_NAME = "Wavs Dir Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Where are your audio (wav) files?", **kwargs,
        )

    def sanitize_input(self, response):
        return str(response).strip()

    def validate(self, response) -> bool:
        return Path(str(response)).expanduser().is_dir()

    def effect(self):
        self.dataset["data_dir"] = Path(str(self.response)).expanduser()


class ValidateWavsStep(DatasetStep):
    """Check (a sample of) the filelist's wav files exist; on misses the
    user may re-pick the wav directory or continue with a warning."""

    DEFAULT_NAME = "Validate Wavs Step"
    MAX_SAMPLES = 1000
    RETRY = "yes, pick a different wavs directory"
    CONTINUE = "no, I will fix missing audio later"

    def _missing(self) -> list:
        import random

        ds = self.dataset
        wavs_dir = Path(ds.get("data_dir", "."))
        rows = ds.get("rows") or []
        if len(rows) > self.MAX_SAMPLES:
            sample = random.sample(rows, self.MAX_SAMPLES)
        else:
            sample = rows
        missing = []
        for row in sample:
            base = str(row.get("basename", ""))
            if not base.endswith(".wav"):
                base += ".wav"
            if not (wavs_dir / base).exists():
                missing.append(base)
        return missing

    def looks_like_choice(self):
        return [self.RETRY, self.CONTINUE]

    def run(self):
        missing = self._missing()
        if not missing:
            logger.info("All audio files in the filelist were found.")
            self.response = "OK"
            self.completed = True
            return
        logger.warning(
            f"{len(missing)} wav files from the filelist were not found "
            f"(e.g. '{missing[0]}'). Check the wavs directory and filelist."
        )
        self.prompt_text = (
            f"{len(missing)} audio files are missing. Do you want to pick a "
            "different wavs directory?"
        )
        super().run()

    def validate(self, response) -> bool:
        return str(response).strip().lower()[:3] in ("ok", "yes", "no,", "no")

    def effect(self):
        assert self.tour is not None
        if str(self.response).strip().lower().startswith("yes"):
            self.tour.add_steps_right_after(
                [
                    WavsDirStep(
                        self.dataset_index,
                        name=f"Wavs Dir Step {self.dataset_index} (retry)",
                    ),
                    ValidateWavsStep(
                        self.dataset_index,
                        name=f"Validate Wavs Step {self.dataset_index} (retry)",
                    ),
                ],
                self,
            )
        else:
            logger.warning(
                "Continuing with missing audio files; those filelist entries "
                "will be skipped during preprocessing."
            )


class SampleRateConfigStep(DatasetStep):
    DEFAULT_NAME = "Sample Rate Config Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="What is the sample rate (in Hertz) of your data?",
            default="22050", **kwargs,
        )

    def validate(self, response) -> bool:
        try:
            value = int(str(response))
        except ValueError:
            return False
        return value >= 100

    def effect(self):
        self.dataset["sample_rate"] = int(str(self.response))


class SymbolSetStep(DatasetStep):
    """Automatic symbol discovery from the filelist text — runs without a
    prompt."""

    DEFAULT_NAME = "Symbol-Set Step"

    def run(self):
        self.response = True
        self.completed = True
        self.effect()

    def effect(self):
        from everyvoice_tpu_torch.config import PUNCTUATION
        from everyvoice_tpu_torch.text.arpabet import arpabet_to_ipa
        from everyvoice_tpu_torch.text.utils import (
            guess_graphemes_in_text_lines,
            guess_ipa_phones_in_text_lines,
        )

        ds = self.dataset
        rows = ds.get("rows") or []
        characters = [r["characters"] for r in rows if r.get("characters")]
        phones = [r["phones"] for r in rows if r.get("phones")]
        if ds.get("text_representation") == "arpabet":
            phones = phones + [
                arpabet_to_ipa(r["arpabet"]) for r in rows if r.get("arpabet")
            ]
        punctuation = {p for marks in PUNCTUATION.values() for p in marks}
        symbols: dict = {}
        if characters:
            found = guess_graphemes_in_text_lines(characters)
            symbols["characters"] = sorted(
                s for s in found if s.strip() and s not in punctuation
            )
        if phones:
            found = guess_ipa_phones_in_text_lines(phones)
            symbols["phones"] = sorted(
                s for s in found if s.strip() and s not in punctuation
            )
        ds["symbols"] = symbols


class SoxEffectsStep(DatasetStep):
    """Select audio preprocessing effects; mono mixdown always applies."""

    DEFAULT_NAME = "Sox Effects Step"
    CHOICES = [
        "none",
        "normalization (-3.0dB)",
        "remove silence at start and end",
        "remove silence throughout",
    ]
    EFFECT_SPECS = {
        "normalization (-3.0dB)": [["norm", "-3.0"]],
        "remove silence at start and end": [
            ["silence", "1", "0.1", "0.1%"],
            ["reverse"],
            ["silence", "1", "0.1", "0.1%"],
            ["reverse"],
        ],
        "remove silence throughout": [
            ["silence", "1", "0.1", "1.0%", "-1", "0.4", "1%"],
        ],
    }

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text=(
                "Which audio preprocessing should be applied? (mono mixdown "
                "always applies; pick one or a comma-separated list)"
            ),
            default="none", **kwargs,
        )

    def looks_like_choice(self):
        return self.CHOICES

    def _parse(self, response) -> list | None:
        chosen = []
        for part in str(response).split(","):
            part = part.strip().lower()
            if not part or part in ("none", "mixdown to mono"):
                continue
            matches = [
                c for c in self.EFFECT_SPECS if c.lower().startswith(part)
            ]
            if len(matches) != 1:
                return None
            chosen.append(matches[0])
        return chosen

    def validate(self, response) -> bool:
        return self._parse(response) is not None

    def effect(self):
        effects = [["channels", "1"]]
        for choice in self._parse(self.response) or []:
            effects += self.EFFECT_SPECS[choice]
        self.dataset["sox_effects"] = effects


class DatasetNameStep(DatasetStep):
    DEFAULT_NAME = "Dataset Name Step"

    def __init__(self, dataset_index: int = 0, **kwargs):
        super().__init__(
            dataset_index,
            prompt_text="Give this dataset a name:",
            default=f"dataset{dataset_index}", **kwargs,
        )

    def validate(self, response) -> bool:
        if not re.match(r"^[\w\d\-]+$", str(response)):
            return False
        taken = {
            d.get("label")
            for i, d in enumerate(self.state.get("datasets", []))
            if i != self.dataset_index
        }
        if str(response) in taken:
            logger.warning(
                f"Dataset name '{response}' is already used; names must be "
                "unique within a project."
            )
            return False
        return True

    def effect(self):
        self.dataset["label"] = str(self.response)


# ---------------------------------------------------------------------------
# OOD data sources


class OODDataStep(Step):
    """Pick where StyleTTS2's out-of-domain reference texts come from, for
    one language."""

    DEFAULT_NAME = "OOD Data Step"
    CHOICES = [
        "validation: use the validation set data",
        "local: provide a path to a local plain-text file",
        "hf: download from a HuggingFace Hub repository",
        "skip: no OOD data",
    ]

    def __init__(self, lang: str = "und", **kwargs):
        self.lang = lang
        kwargs.setdefault("name", f"OOD Data Step [{lang}]")
        super().__init__(
            prompt_text=(
                f"StyleTTS2's WavLM discriminator uses out-of-domain text in "
                f"'{lang}' (text only, no audio needed). Where should it "
                "come from? Using the validation set pollutes the train/val "
                "split slightly, which is fine outside research settings."
            ),
            default=self.CHOICES[0], **kwargs,
        )

    def looks_like_choice(self):
        return self.CHOICES

    def sanitize_input(self, response):
        text = str(response).strip().lower()
        for choice in self.CHOICES:
            if choice.startswith(text.split(":")[0]):
                return choice.split(":")[0]
        return "" if not text else text.split(":")[0]

    def validate(self, response) -> bool:
        return str(response) in ("validation", "local", "hf", "skip", "")

    def effect(self):
        choice = str(self.response)
        ood = self.state.setdefault("ood_raw_data", {})
        assert self.tour is not None
        if choice == "local":
            self.tour.add_steps_right_after(
                [OODLocalPathStep(self.lang)], self
            )
        elif choice == "hf":
            self.tour.add_steps_right_after(
                [OODHFRepoStep(self.lang)], self
            )
        elif choice == "validation":
            ood[self.lang] = {"source_type": "validation"}


class OODLocalPathStep(Step):
    DEFAULT_NAME = "OOD Local Path Step"

    def __init__(self, lang: str = "und", **kwargs):
        self.lang = lang
        kwargs.setdefault("name", f"OOD Local Path Step [{lang}]")
        super().__init__(
            prompt_text=(
                f"Path to a local plain-text file with OOD sentences for "
                f"'{lang}' (one per line, or a psv with a characters/phones "
                "column):"
            ),
            **kwargs,
        )

    def validate(self, response) -> bool:
        return Path(str(response)).expanduser().is_file()

    def effect(self):
        path = Path(str(self.response)).expanduser()
        first_line = ""
        try:
            with open(path, encoding="utf8") as f:
                first_line = f.readline()
        except OSError:
            pass
        fields = {f.strip() for f in first_line.split("|")}
        representation = (
            "phones" if "phones" in fields
            else "characters"
        )
        self.state.setdefault("ood_raw_data", {})[self.lang] = {
            "source_type": "local",
            "local_path": str(path),
            "text_representation": representation,
        }


class OODHFRepoStep(Step):
    DEFAULT_NAME = "OOD HF Repo Step"

    def __init__(self, lang: str = "und", **kwargs):
        self.lang = lang
        kwargs.setdefault("name", f"OOD HF Repo Step [{lang}]")
        super().__init__(
            prompt_text=(
                f"HuggingFace dataset repo and filename for '{lang}' OOD "
                "data, as 'owner/repo:filename' "
                "(e.g. everyvoice/StyleTTS2-English-OOD:OOD_texts.txt):"
            ),
            default=(
                "everyvoice/StyleTTS2-English-OOD:OOD_texts.txt"
                if lang == "eng" else ""
            ),
            **kwargs,
        )

    def validate(self, response) -> bool:
        text = str(response).strip()
        if not text:
            return False
        repo = text.split(":")[0]
        return "/" in repo

    def effect(self):
        text = str(self.response).strip()
        repo, _, filename = text.partition(":")
        self.state.setdefault("ood_raw_data", {})[self.lang] = {
            "source_type": "hf",
            "repo_id": repo,
            "filename": filename or "ood.txt",
            "text_representation": "characters",
        }


class MoreDatasetsStep(Step):
    DEFAULT_NAME = "More Datasets Step"

    def __init__(self, **kwargs):
        super().__init__(
            prompt_text="Do you have more datasets to add? (yes/no)",
            default="no", **kwargs,
        )

    def looks_like_choice(self):
        return list(YES_NO)

    def validate(self, response) -> bool:
        return str(response).strip().lower() in YES_NO + ("y", "n")

    def effect(self):
        assert self.tour is not None
        if _is_yes(self.response):
            next_index = len(self.state.get("datasets", []))
            subtour = get_dataset_steps(next_index)
            another = MoreDatasetsStep(name=f"More Datasets Step {next_index}")
            self.tour.add_steps_right_after(subtour + [another], self)
        elif not self.state.get("datasets"):
            logger.warning(
                "No dataset was configured; exiting without writing any "
                "project files."
            )
        else:
            # Wrap up: one OOD source question per language, then the
            # config-format question whose effect writes everything.
            languages = sorted(
                {
                    row.get("language", "und")
                    for ds in self.state.get("datasets", [])
                    for row in ds.get("rows", []) or []
                }
                | {
                    ds["language"]
                    for ds in self.state.get("datasets", [])
                    if ds.get("language")
                }
            ) or ["und"]
            self.tour.add_steps_right_after(
                [OODDataStep(lang) for lang in languages]
                + [ConfigFormatStep()],
                self,
            )


class ConfigFormatStep(Step):
    """Final step: choose yaml or json, then write the whole project.
    Writing to disk is not undoable."""

    DEFAULT_NAME = "Config Format Step"
    reversible = False

    def __init__(self, **kwargs):
        super().__init__(
            prompt_text="Which format should the configuration files use?",
            default="yaml", **kwargs,
        )

    def looks_like_choice(self):
        return ["yaml", "json"]

    def validate(self, response) -> bool:
        return str(response).strip().lower() in ("yaml", "json")

    def effect(self):
        self.state["config_format"] = str(self.response).strip().lower()
        write_config_package(self.state, fmt=self.state["config_format"])


# ---------------------------------------------------------------------------
# helpers


def _has_columns_left(ds: dict) -> bool:
    """Whether any filelist column is still unassigned (festival filelists
    have no free columns)."""
    if ds.get("format") == "festival":
        return False
    headers = ds.get("headers") or []
    return len(ds.get("selected", [])) < len(headers)


def _finalize_filelist_rows(ds: dict) -> None:
    """Rename leftover columns to unknown_<i>, convert the row lists to
    dicts, and fill in default speaker/language values."""
    if ds.get("format") == "festival":
        rows = ds.get("rows") or []
    else:
        headers = ds.get("headers") or []
        for i, header in enumerate(headers):
            if header not in STANDARD_HEADERS:
                headers[i] = f"unknown_{i}"
        rows = [
            {headers[i]: record[i] for i in range(min(len(record), len(headers)))}
            for record in ds.get("data_list", [])[1:]
        ]
        ds["rows"] = rows
    # A speaker_id / language chosen interactively means "the filelist has
    # no such column", so it overrides whatever the rows carry.
    default_speaker = ds.get("speaker_id")
    chosen_language = ds.get("language")
    for row in rows:
        if default_speaker or not row.get("speaker"):
            row["speaker"] = default_speaker or "default"
        if chosen_language or not row.get("language"):
            row["language"] = chosen_language or "und"


def get_dataset_steps(dataset_index: int = 0) -> list:
    return [
        FilelistStep(dataset_index),
        PermissionsStep(dataset_index),
        FilelistFormatStep(dataset_index),
        TextRepresentationStep(dataset_index),
        TextProcessingStep(dataset_index),
        HasSpeakerStep(dataset_index),
        HasLanguageStep(dataset_index),
        CustomG2PStep(dataset_index),
        WavsDirStep(dataset_index),
        ValidateWavsStep(dataset_index),
        SampleRateConfigStep(dataset_index),
        SymbolSetStep(dataset_index),
        SoxEffectsStep(dataset_index),
        DatasetNameStep(dataset_index),
    ]


# ---------------------------------------------------------------------------
# config writing


def write_config_package(state: dict, fmt: str = "yaml") -> Path:
    import os

    from everyvoice_tpu_torch.utils import write_config_file, write_filelist

    suffix = ".json" if fmt == "json" else ".yaml"
    files = {key: f"{stem}{suffix}" for key, stem in CONFIG_STEMS.items()}

    name = state.get("name", "project")
    slug = re.sub(r"\s+", "-", name.strip())
    out_root = Path(state.get("output_path", ".")) / slug
    config_dir = out_root / "config"
    config_dir.mkdir(parents=True, exist_ok=True)
    (out_root / "preprocessed").mkdir(exist_ok=True)
    (out_root / "logs_and_checkpoints").mkdir(exist_ok=True)

    def portable(path: Path | str) -> str:
        """Paths in written configs resolve against the config file's own
        directory at load time. User paths given relative to the wizard's
        cwd are rewritten relative to config_dir (e.g.
        '../../Common-Voice'); user-given absolute
        paths OUTSIDE the project stay absolute; anything inside the
        project becomes '../<x>' so the whole project directory is
        relocatable."""
        path = Path(path)
        resolved = path if path.is_absolute() else (Path.cwd() / path)
        resolved = resolved.resolve()
        project_root = (Path.cwd() / out_root).resolve()
        if path.is_absolute() and not resolved.is_relative_to(project_root):
            return str(path)
        return os.path.relpath(resolved, (Path.cwd() / config_dir).resolve())

    datasets = state.get("datasets", [])
    languages = set()
    speakers = set()
    for d in datasets:
        for row in d.get("rows", []) or []:
            speakers.add(row.get("speaker") or "default")
            languages.add(row.get("language") or d.get("language", "und"))
        if d.get("language"):
            languages.add(d["language"])
    multilingual = len(languages) > 1
    multispeaker = len(speakers) > 1

    # --- shared text config
    symbols: dict = {}
    dataset_cleaners: dict = {}
    for d in datasets:
        label = d.get("label", "dataset")
        found = d.get("symbols")
        if isinstance(found, dict):
            for kind, symbol_list in found.items():
                if symbol_list:
                    symbols[f"{label}_{kind}"] = symbol_list
        elif found:  # plain list from older sessions
            rep = d.get("text_representation", "characters")
            kind = "phones" if rep in ("phones", "arpabet") else "characters"
            symbols[f"{label}_{kind}"] = list(found)
        if d.get("cleaners"):
            dataset_cleaners[label] = d["cleaners"]
    text_config: dict = {"symbols": symbols} if symbols else {}
    if dataset_cleaners:
        text_config["dataset_cleaners"] = dataset_cleaners
    g2p_engines = dict(state.get("custom_g2p", {}))
    for d in datasets:  # back-compat with single-question sessions
        if d.get("g2p_engine") and d.get("language"):
            g2p_engines.setdefault(d["language"], d["g2p_engine"])
    if g2p_engines:
        text_config["g2p_engines"] = g2p_engines
    write_config_file(config_dir / files["text"], text_config)

    # --- shared data config + per-dataset filelists
    source_data = []
    for d in datasets:
        label = d.get("label", "dataset")
        filelist_out = out_root / f"{label}-filelist.psv"
        rows = d.get("rows", []) or []
        if rows:
            write_filelist(rows, filelist_out)
        entry = {
            "label": label,
            "permissions_obtained": True,
            "data_dir": portable(d.get("data_dir", ".")),
            "filelist": portable(filelist_out if rows else d.get("filelist", "")),
        }
        if d.get("sox_effects") is not None:
            entry["sox_effects"] = d["sox_effects"]
        source_data.append(entry)
    data_config = {
        "dataset": slug,
        "save_dir": portable(out_root / "preprocessed"),
        "source_data": source_data,
    }
    sample_rates = {d["sample_rate"] for d in datasets if d.get("sample_rate")}
    if len(sample_rates) > 1:
        logger.warning(
            f"Datasets declare different sample rates {sorted(sample_rates)}; "
            f"using {sorted(sample_rates)[0]} — audio at other rates will be "
            "resampled during preprocessing."
        )
    if sample_rates and sample_rates != {22050}:
        rate = sorted(sample_rates)[0]
        # All three rates move together; leaving output/alignment at the
        # 22050 default would give a zero hop ratio downstream.
        data_config["audio"] = {
            "input_sampling_rate": rate,
            "output_sampling_rate": rate,
            "alignment_sampling_rate": rate,
        }
    write_config_file(config_dir / files["data"], data_config)

    contact = {
        "contact_name": state.get("contact_name", ""),
        "contact_email": state.get("contact_email", ""),
    }
    preprocessed = out_root / "preprocessed"
    training_shared = {
        "training_filelist": portable(preprocessed / "training_filelist.psv"),
        "validation_filelist": portable(preprocessed / "validation_filelist.psv"),
        "logger": {"save_dir": portable(out_root / "logs_and_checkpoints")},
    }

    # --- model configs referencing the shared partials
    fs2 = {
        "contact": contact,
        "path_to_preprocessing_config_file": files["data"],
        "path_to_text_config_file": files["text"],
        "model": {"multilingual": multilingual, "multispeaker": multispeaker},
        "training": dict(training_shared),
    }
    write_config_file(config_dir / files["text-to-spec"], fs2)
    hifigan = {
        "contact": contact,
        "path_to_preprocessing_config_file": files["data"],
        "training": dict(training_shared),
    }
    write_config_file(config_dir / files["spec-to-wav"], hifigan)
    styletts2 = {
        "contact": contact,
        "path_to_preprocessing_config_file": files["data"],
        "path_to_text_config_file": files["text"],
        "model": {"multilingual": multilingual, "multispeaker": multispeaker},
        "training": dict(training_shared),
    }
    ood_raw = dict(state.get("ood_raw_data", {}))
    # back-compat with single-question sessions
    if state.get("ood_use_validation"):
        for lang in sorted(languages) or ["und"]:
            ood_raw.setdefault(lang, {"source_type": "validation"})
    elif state.get("ood_local_path"):
        for lang in sorted(languages) or ["und"]:
            ood_raw.setdefault(
                lang,
                {"source_type": "local",
                 "local_path": str(state["ood_local_path"])},
            )
    if any(v.get("source_type") == "validation" for v in ood_raw.values()):
        styletts2["training"]["use_validation_as_ood"] = True
    # Convert the wizard's internal {source_type, ...} records into the
    # OODDataSource schema shape (local_path / nested hf), which forbids
    # extra fields — a raw dump would make the written config unloadable.
    ood_config = {}
    for lang, spec in ood_raw.items():
        kind = spec.get("source_type")
        if kind == "local":
            entry = {"local_path": str(spec.get("local_path", ""))}
        elif kind == "hf":
            entry = {
                "hf": {
                    "repo_id": spec.get("repo_id"),
                    "filename": spec.get("filename", "ood.txt"),
                }
            }
        else:  # validation handled via use_validation_as_ood above
            continue
        if spec.get("text_representation"):
            entry["text_representation"] = spec["text_representation"]
        ood_config[lang] = entry
    if ood_config:
        styletts2["training"]["ood_raw_data"] = ood_config
    write_config_file(config_dir / files["text-to-wav"], styletts2)

    logger.info(f"Wrote project '{name}' to {out_root}")
    state["project_dir"] = out_root
    return out_root
