"""The port's new-project wizard (everyvoice_tpu_torch/wizard/) with scripted
answers: each test of tests/test_wizard.py mirrored on the port, then
parity with the JAX wizard. Where the JAX tests read the reference's LJ
snippet, these read a seeded corpus (``onchip.write_corpus``) with a phones
column, and its festival, TSV-with-language and headerless variants written
beside it.

Parity, with its bounds: the same answers through both tours give
filelists equal byte for byte and config files that PyYAML (or JSON) loads
to equal dicts; each package loads the other's project and resumes the
other's saved session to the same project; the wizard's text and filelist
helpers give the JAX package's results (``is_sentence_final`` against
``regex`` over every code point).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from everyvoice_tpu_torch.config_files import load_config_from_path
from everyvoice_tpu_torch.onchip import write_corpus
from everyvoice_tpu_torch.wizard.main_tour import get_main_wizard_tour
from everyvoice_tpu_torch.wizard.steps import NameStep, write_config_package
from everyvoice_tpu_torch.wizard.tour import Step, StepError, Tour

REPO = Path(__file__).resolve().parents[1]
UTTERANCES = 6
PHONES = ("ðə kwɪk bɹaʊn", "hɛloʊ wɜld", "ʃi sɛlz sixʃɛlz", "ə ŋ θ ʒ")


@pytest.fixture(scope="module")
def data(tmp_path_factory) -> Path:
    """A seeded corpus and its filelists: ``metadata.psv`` (basename,
    characters, phones, speaker, language), ``metadata.festival``,
    ``language-col.tsv`` (two languages, two speakers) and wavs in
    ``wavs/``."""
    root = tmp_path_factory.mktemp("wizard-corpus")
    filelist, _, _ = write_corpus(root, UTTERANCES, seed=3)
    rows = [line.split("|") for line in filelist.read_text(encoding="utf8").splitlines()[1:]]
    psv = ["basename|characters|phones|speaker|language"]
    festival, tsv = [], ["basename\tcharacters\tspeaker\tlanguage"]
    for i, (base, text, _, _) in enumerate(rows):
        psv.append(f"{base}|{text}|{PHONES[i % len(PHONES)]}|default|default")
        festival.append(f'( {base} "{text}" )')
        lang = ("en", "es")[i % 2]
        tsv.append(f"{base}\t{text}\tspeaker-{lang}\t{lang}")
    (root / "metadata.psv").write_text("\n".join(psv) + "\n", encoding="utf8")
    (root / "metadata.festival").write_text("\n".join(festival) + "\n", encoding="utf8")
    (root / "language-col.tsv").write_text("\n".join(tsv) + "\n", encoding="utf8")
    return root


def first_text(data: Path) -> str:
    return (data / "metadata.psv").read_text(encoding="utf8").splitlines()[1].split("|")[1]


def scripted_ask(answers):
    """An ask() that pops scripted answers in order."""
    queue = list(answers)

    def ask(prompt_text, default=None, step=None):
        if not queue:
            raise AssertionError(f"Wizard asked an unscripted question: {prompt_text}")
        return queue.pop(0)

    return ask


def dataset_answers(filelist, wavs_dir, name="lj", language=None):
    """Answers for one dataset subtour over a psv filelist that already has
    speaker and language columns."""
    answers = [
        str(filelist), "yes", "psv", "characters", "none",
        "yes",                                # has speaker column (auto-picks 'speaker')
        "yes" if language is None else "no",  # has language column
    ]
    if language is not None:
        answers.append(language)  # SelectLanguageStep
    answers += ["keep", str(wavs_dir), "22050", "none", name]
    return answers


def closing_answers(n_languages=1):
    return ["validation"] * n_languages + ["yaml"]


def lj_answers(tmp_path, data, more="no"):
    return (["Test Project", "Test Runner", "info@everyvoice.ca", str(tmp_path)]
            + dataset_answers(data / "metadata.psv", data / "wavs") + [more])


class TestMainTour:
    def test_full_tour_writes_project(self, tmp_path, data):
        state = get_main_wizard_tour(
            ask=scripted_ask(lj_answers(tmp_path, data) + closing_answers())).run()
        project = state["project_dir"]
        for fn in ("everyvoice-shared-text.yaml", "everyvoice-shared-data.yaml",
                   "everyvoice-text-to-spec.yaml", "everyvoice-spec-to-wav.yaml",
                   "everyvoice-text-to-wav.yaml"):
            assert (project / "config" / fn).exists(), fn
        assert (project / "preprocessed").is_dir()
        assert (project / "logs_and_checkpoints").is_dir()
        assert (project / "lj-filelist.psv").exists()

    def test_written_configs_load(self, tmp_path, data):
        state = get_main_wizard_tour(
            ask=scripted_ask(lj_answers(tmp_path, data) + closing_answers())).run()
        config_dir = state["project_dir"] / "config"
        fs2 = load_config_from_path("text-to-spec", config_dir / "everyvoice-text-to-spec.yaml")
        assert fs2["contact"]["contact_email"] == "info@everyvoice.ca"
        assert "lj_characters" in fs2["text"]["symbols"]
        load_config_from_path("spec-to-wav", config_dir / "everyvoice-spec-to-wav.yaml")
        load_config_from_path("text-to-wav", config_dir / "everyvoice-text-to-wav.yaml")

    def test_symbol_discovery(self, tmp_path, data):
        state = get_main_wizard_tour(
            ask=scripted_ask(lj_answers(tmp_path, data) + closing_answers())).run()
        symbols = state["datasets"][0]["symbols"]
        assert "a" in symbols["characters"] or "e" in symbols["characters"]
        assert "." not in symbols["characters"]
        assert symbols["phones"]

    def test_permission_denied_exits(self, tmp_path, data):
        answers = lj_answers(tmp_path, data)
        answers[5] = "no"
        with pytest.raises(SystemExit):
            get_main_wizard_tour(ask=scripted_ask(answers)).run()

    def test_more_datasets_loops(self, tmp_path, data):
        answers = lj_answers(tmp_path, data, more="yes")
        answers += dataset_answers(data / "metadata.psv", data / "wavs", name="second",
                                   language="fra")
        answers += ["no"] + closing_answers(n_languages=2)
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        assert len(state["datasets"]) == 2
        assert state["datasets"][1]["language"] == "fra"
        fs2 = yaml.safe_load(
            (state["project_dir"] / "config" / "everyvoice-text-to-spec.yaml").read_text())
        assert fs2["model"]["multilingual"] is True


class RecordingStep(Step):
    """Step that writes its answer into shared state (undo must revert)."""

    def __init__(self, key, **kwargs):
        super().__init__(name=key, prompt_text=f"{key}?", **kwargs)
        self.key = key

    def effect(self):
        self.state[self.key] = self.response


class InsertingStep(RecordingStep):
    """Step whose effect inserts a follow-up step (like MoreDatasets)."""

    def effect(self):
        super().effect()
        if self.response == "yes":
            assert self.tour is not None
            self.tour.add_steps_right_after([RecordingStep("extra")], self)


class TestTourMechanics:
    def test_validation_retry_then_fail(self):
        class EmailStep(Step):
            def validate(self, response):
                return "@" in str(response)

        tour = Tour("t", [EmailStep(name="email")], ask=scripted_ask(["bad email"] * 25))
        with pytest.raises(StepError, match="20 times"):
            tour.run()

    def test_trace_and_debug_state_modes(self, capsys):
        tour = Tour("t", [RecordingStep("first"), RecordingStep("second")],
                    ask=scripted_ask(["A", "B"]), trace=True, debug_state=True)
        tour.run()
        out = capsys.readouterr().out
        assert "first: 'A'" in out
        assert "second: 'B'" in out
        assert "[wizard state before second]" in out
        assert "'first': 'A'" in out

    def test_save_and_resume(self, tmp_path):
        tour = Tour("t", [NameStep()], ask=scripted_ask(["My Project"]))
        tour.run()
        progress = tmp_path / "progress.yaml"
        tour.save_progress(progress)
        state = Tour("t", [NameStep()], ask=scripted_ask([])).run(resume_from=progress)
        assert state["name"] == "My Project"


class TestConfigPackage:
    def test_write_config_package_minimal(self, tmp_path):
        state = {
            "name": "mini", "output_path": tmp_path, "contact_name": "X",
            "contact_email": "x@y.org",
            "datasets": [{
                "label": "d0", "language": "und", "data_dir": tmp_path,
                "filelist": tmp_path / "none.psv",
                "rows": [{"basename": "a", "characters": "hi"}],
                "symbols": ["h", "i"], "text_representation": "characters",
            }],
        }
        out = write_config_package(state)
        assert (out / "config" / "everyvoice-shared-data.yaml").exists()
        loaded = yaml.safe_load((out / "config" / "everyvoice-shared-data.yaml").read_text())
        assert loaded["source_data"][0]["label"] == "d0"


class TestColumnMapping:
    def test_nonstandard_column_mapped(self, tmp_path):
        filelist = tmp_path / "f.psv"
        filelist.write_text("basename|text\nitem1|hello there\n")
        answers = [
            "Col Project", "Test Runner", "info@everyvoice.ca", str(tmp_path),
            str(filelist), "yes", "psv", "characters", "none",
            "no",    # know-speaker (has-speaker auto-answers no)
            "eng",   # select language (no language column)
            "keep", str(tmp_path),
            "no",    # validate wavs: continue despite missing
            "22050", "none", "cols", "no", "skip", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert rows[0]["characters"] == "hello there"
        assert rows[0]["language"] == "eng"
        assert rows[0]["speaker"] == "speaker_0"

    def test_standard_columns_skip_mapping(self, tmp_path, data):
        state = get_main_wizard_tour(
            ask=scripted_ask(lj_answers(tmp_path, data) + closing_answers())).run()
        assert state["datasets"][0]["rows"][0]["characters"] == first_text(data)


INTERRUPT = object()  # sentinel: scripted Ctrl-C during a prompt


def interruptable_ask(answers):
    queue = list(answers)

    def ask(prompt_text, default=None, step=None):
        if not queue:
            raise AssertionError(f"Unscripted question: {prompt_text}")
        answer = queue.pop(0)
        if answer is INTERRUPT:
            raise KeyboardInterrupt
        return answer

    return ask


class TestInterruptMenu:
    def _tour(self, answers):
        return Tour("t", [RecordingStep("first"), RecordingStep("second")],
                    ask=interruptable_ask(answers))

    def test_go_back_re_prompts_previous_step(self):
        tour = self._tour(["A", INTERRUPT, "go back a step", "B", "C"])
        state = tour.run()
        assert state["first"] == "B" and state["second"] == "C"
        assert [name for name, _ in tour.trace] == ["first", "second"]

    def test_continue_resumes_current_step(self):
        state = self._tour(["A", INTERRUPT, "continue", "C"]).run()
        assert state["first"] == "A" and state["second"] == "C"

    def test_save_and_exit_then_resume(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit):
            self._tour(["A", INTERRUPT, "save and exit"]).run()
        saved = tmp_path / "t-progress.yaml"
        assert saved.exists()
        state = self._tour(["C2"]).run(resume_from=saved)
        assert state["first"] == "A" and state["second"] == "C2"

    def test_exit_without_saving(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        with pytest.raises(SystemExit):
            self._tour(["A", INTERRUPT, "exit"]).run()
        assert not (tmp_path / "t-progress.yaml").exists()

    def test_view_progress_then_continue(self):
        state = self._tour(["A", INTERRUPT, "view progress", "continue", "C"]).run()
        assert state == {"first": "A", "second": "C"}


class TestUndoSemantics:
    def test_undo_reverts_state_and_inserted_steps(self):
        answers = ["yes", INTERRUPT, "go back a step", "no", "B"]
        tour = Tour("t", [InsertingStep("insert"), RecordingStep("second")],
                    ask=interruptable_ask(answers))
        state = tour.run()
        assert state["insert"] == "no"
        assert "extra" not in state
        assert state["second"] == "B"

    def test_irreversible_step_blocks_back(self):
        class Fixed(RecordingStep):
            reversible = False

        tour = Tour("t", [Fixed("first"), RecordingStep("second")],
                    ask=interruptable_ask(["A", INTERRUPT, "go back a step", "C"]))
        state = tour.run()
        assert state["first"] == "A" and state["second"] == "C"


class TestResumeVersioning:
    def test_incompatible_version_rejected(self, tmp_path):
        bad = tmp_path / "progress.yaml"
        bad.write_text("tour: t\nversion: '2.0'\nresponses:\n- [first, A]\n", encoding="utf8")
        with pytest.raises(StepError):
            Tour.load_progress(bad)

    def test_not_a_session_file_rejected(self, tmp_path):
        bad = tmp_path / "junk.yaml"
        bad.write_text("just: stuff\n", encoding="utf8")
        with pytest.raises(StepError):
            Tour.load_progress(bad)


def _base(tmp_path):
    return ["P", "Test Runner", "info@everyvoice.ca", str(tmp_path)]


class TestFilelistFormats:
    def test_festival_format(self, tmp_path, data):
        answers = _base(tmp_path) + [
            str(data / "metadata.festival"), "yes", "festival", "characters", "none",
            "no",   # know speaker (has-speaker auto-no: festival has no columns)
            "eng",  # select language
            "keep", str(data / "wavs"), "22050", "none", "fest", "no", "validation", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert rows[0]["basename"].startswith("utt")
        assert rows[0]["language"] == "eng"
        assert rows[0]["speaker"] == "speaker_0"
        assert rows[0]["characters"] == first_text(data)

    def test_tsv_with_language_column(self, tmp_path, data):
        answers = _base(tmp_path) + [
            str(data / "language-col.tsv"), "yes", "tsv", "characters", "none",
            "yes", "yes", "keep", str(tmp_path),
            "no",   # validate wavs: continue despite missing
            "22050", "none", "langcol", "no", "validation", "validation", "yaml",
        ]
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        rows = state["datasets"][0]["rows"]
        assert sorted({r["language"] for r in rows}) == ["en", "es"]
        assert sorted({r["speaker"] for r in rows}) == ["speaker-en", "speaker-es"]
        fs2 = yaml.safe_load(
            (state["project_dir"] / "config" / "everyvoice-text-to-spec.yaml").read_text())
        assert fs2["model"]["multilingual"] is True
        assert fs2["model"]["multispeaker"] is True

    def test_headerless_filelist_mapping(self, tmp_path):
        filelist = tmp_path / "noheader.psv"
        filelist.write_text("item1|hello world\nitem2|more text\n")
        answers = _base(tmp_path) + [
            str(filelist), "yes", "psv", "no", "1", "0", "characters", "none",
            "no", "eng", "keep", str(tmp_path), "no", "22050", "none", "nh", "no", "skip", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert len(rows) == 2
        assert rows[0]["basename"] == "item1"
        assert rows[0]["characters"] == "hello world"

    def test_escaped_delimiter_round_trip(self, tmp_path):
        from everyvoice_tpu_torch.utils import write_filelist

        filelist = tmp_path / "escaped.psv"
        write_filelist([{"basename": "item1", "characters": "hello | world"},
                        {"basename": "item2", "characters": "plain text"}], filelist)
        assert "\\|" in filelist.read_text()
        answers = _base(tmp_path) + [
            str(filelist), "yes", "psv", "characters", "none",
            "no", "eng", "keep", str(tmp_path), "no", "22050", "none", "esc", "no", "skip", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert len(rows) == 2
        assert rows[0]["characters"] == "hello | world"

    def test_validate_wavs_retry_path(self, tmp_path, data):
        answers = _base(tmp_path) + [
            str(data / "metadata.psv"), "yes", "psv", "characters", "none", "yes", "yes", "keep",
            str(tmp_path),      # wrong wav dir -> validation finds missing files
            "yes",              # yes, pick a different directory
            str(data / "wavs"),  # the retry passes silently
            "22050", "none", "lj", "no", "validation", "yaml",
        ]
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        assert state["datasets"][0]["data_dir"] == data / "wavs"


class TestOODAndFormat:
    def test_ood_local_path_and_json_format(self, tmp_path, data):
        ood = tmp_path / "ood.txt"
        ood.write_text("A sentence.\nAnother sentence.\n")
        answers = (["P", "Test Runner", "info@everyvoice.ca", str(tmp_path)]
                   + dataset_answers(data / "metadata.psv", data / "wavs")
                   + ["no", "local", str(ood), "json"])
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        config_dir = state["project_dir"] / "config"
        assert (config_dir / "everyvoice-text-to-wav.json").exists()
        assert not (config_dir / "everyvoice-text-to-wav.yaml").exists()
        e2e = json.loads((config_dir / "everyvoice-text-to-wav.json").read_text())
        (lang, spec), = e2e["training"]["ood_raw_data"].items()
        assert spec["local_path"] == str(ood)
        loaded = load_config_from_path("text-to-wav", config_dir / "everyvoice-text-to-wav.json")
        assert loaded["training"]["ood_raw_data"][lang]["local_path"] == str(ood)

    def test_sample_rate_recorded(self, tmp_path, data):
        answers = [
            "P", "Test Runner", "info@everyvoice.ca", str(tmp_path),
            str(data / "metadata.psv"), "yes", "psv", "characters", "none",
            "yes", "yes", "keep", str(data / "wavs"), "16000", "none", "lj", "no", "validation",
            "yaml",
        ]
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        assert state["datasets"][0]["sample_rate"] == 16000
        loaded = yaml.safe_load(
            (state["project_dir"] / "config" / "everyvoice-shared-data.yaml").read_text())
        assert loaded["audio"]["input_sampling_rate"] == 16000


class TestWizardEdgeCases:
    def test_duplicate_dataset_name_rejected(self, tmp_path, data):
        answers = lj_answers(tmp_path, data, more="yes")
        answers += dataset_answers(data / "metadata.psv", data / "wavs", name="lj")
        answers.append("lj2")  # after the rejection, a unique name
        answers += ["no"] + closing_answers(n_languages=1)
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        assert [d["label"] for d in state["datasets"]] == ["lj", "lj2"]

    def test_path_answers_tolerate_whitespace(self, tmp_path, data):
        answers = [
            "P", "Test Runner", "info@everyvoice.ca", f"  {tmp_path}  ",
            f"  {data / 'metadata.psv'} ", "yes", "psv", "characters", "none", "yes", "yes",
            "keep", f" {data / 'wavs'}", "22050", "none", "lj", "no", "validation", "yaml",
        ]
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        assert state["project_dir"].exists()

    def test_no_datasets_writes_nothing(self, tmp_path):
        from everyvoice_tpu_torch.wizard.steps import MoreDatasetsStep

        Tour("t", [MoreDatasetsStep()], ask=scripted_ask(["no"]),
             state={"name": "empty", "output_path": tmp_path}).run()
        assert not (tmp_path / "empty").exists()


class TestStepValidation:
    def test_name_step(self):
        step = NameStep()
        assert step.validate("My Project-1")
        assert not step.validate("")
        assert not step.validate("foo/bar")
        assert not step.validate("a:b")

    def test_contact_name_step(self):
        from everyvoice_tpu_torch.wizard.steps import ContactNameStep

        step = ContactNameStep()
        assert step.validate("Test Runner")
        assert not step.validate("ab")
        assert not step.validate("   ")

    def test_contact_email_step(self):
        from everyvoice_tpu_torch.wizard.steps import ContactEmailStep

        step = ContactEmailStep()
        assert step.validate("info@everyvoice.ca")
        for bad in ("not-an-email", "a@b", "@b.com", "a b@c.org"):
            assert not step.validate(bad)

    def test_output_path_step_rejects_file(self, tmp_path):
        from everyvoice_tpu_torch.wizard.steps import OutputPathStep

        blocker = tmp_path / "occupied"
        blocker.write_text("not a directory")
        step = OutputPathStep()
        assert not step.validate(str(blocker))
        assert step.validate(str(tmp_path))
        assert step.validate(str(tmp_path / "new-subdir"))

    def test_filelist_step_rejects_missing(self, tmp_path):
        from everyvoice_tpu_torch.wizard.steps import FilelistStep

        step = FilelistStep(0)
        assert not step.validate(str(tmp_path / "nope.psv"))
        real = tmp_path / "real.psv"
        real.write_text("basename|characters\n")
        assert step.validate(str(real))

    def test_sample_rate_step(self):
        from everyvoice_tpu_torch.wizard.steps import SampleRateConfigStep

        step = SampleRateConfigStep(0)
        assert step.validate("44100")
        assert step.validate(22050)
        assert not step.validate("abc")
        assert not step.validate("50")

    def test_dataset_name_step(self):
        from everyvoice_tpu_torch.wizard.steps import DatasetNameStep

        step = DatasetNameStep(0)
        assert step.validate("lj-corpus")
        assert not step.validate("my dataset")
        assert not step.validate("")

    def test_add_speaker_step(self):
        from everyvoice_tpu_torch.wizard.steps import AddSpeakerStep

        step = AddSpeakerStep(0)
        assert step.validate("speaker-2")
        assert not step.validate("Bad Speaker")
        assert not step.validate("")

    def test_sox_effects_parsing(self):
        from everyvoice_tpu_torch.wizard.steps import SoxEffectsStep

        step = SoxEffectsStep(0)
        assert step.validate("none")
        assert step.validate("normalization (-3.0dB), remove silence at start and end")
        assert not step.validate("reverb please")
        step.response = "normalization (-3.0dB)"
        step.effect()
        effects = step.dataset["sox_effects"]
        assert effects[0] == ["channels", "1"]
        assert ["norm", "-3.0"] in effects

    def test_ood_hf_repo_step(self):
        from everyvoice_tpu_torch.wizard.steps import OODHFRepoStep

        step = OODHFRepoStep("eng")
        assert not step.validate("")
        assert not step.validate("norepo")
        assert step.validate("owner/repo:OOD.txt")
        step.response = "owner/repo:OOD.txt"
        step.effect()
        assert step.state["ood_raw_data"]["eng"] == {
            "source_type": "hf", "repo_id": "owner/repo", "filename": "OOD.txt",
            "text_representation": "characters"}

    def test_ood_hf_repo_default_filename(self):
        from everyvoice_tpu_torch.wizard.steps import OODHFRepoStep

        step = OODHFRepoStep("fra")
        step.response = "owner/repo"
        step.effect()
        assert step.state["ood_raw_data"]["fra"]["filename"] == "ood.txt"


class TestLanguagePicker:
    def test_choices_list_registered_languages(self):
        from everyvoice_tpu_torch.wizard.steps import SelectLanguageStep

        choices = SelectLanguageStep(0).looks_like_choice()
        assert any(c.startswith("[eng]: English") for c in choices)
        assert choices[0].startswith("[und]")
        assert choices[1].startswith("[custom]")

    def test_menu_answer_sanitized_to_code(self):
        from everyvoice_tpu_torch.wizard.steps import SelectLanguageStep

        step = SelectLanguageStep(0)
        assert step.sanitize_input("[eng]: English") == "eng"
        assert step.sanitize_input("fra") == "fra"
        assert not step.validate(step.sanitize_input("not a code!"))

    def test_custom_language_code_flow(self):
        from everyvoice_tpu_torch.wizard.steps import SelectLanguageStep

        state = Tour("t", [SelectLanguageStep(0)],
                     ask=scripted_ask(["custom", "gitx-dialect"])).run()
        assert state["datasets"][0]["language"] == "gitx-dialect"


class TestValidationBailout:
    def test_twenty_failures_abort(self):
        class AlwaysBad(Step):
            def validate(self, response):
                return False

        tour = Tour("t", [AlwaysBad(name="bad", prompt_text="?")],
                    ask=lambda prompt_text, default=None, step=None: "x")
        with pytest.raises(StepError, match="20 times"):
            tour.run()


class TestFormatSniffRecovery:
    def _format_tour(self, filelist, answers):
        from everyvoice_tpu_torch.wizard.steps import FilelistFormatStep, FilelistStep

        return Tour("t", [FilelistStep(0), FilelistFormatStep(0)],
                    ask=scripted_ask([str(filelist)] + answers))

    def test_wrong_format_then_right(self, data):
        state = self._format_tour(data / "metadata.psv", ["csv", "psv"]).run()
        assert state["datasets"][0]["format"] == "psv"

    def test_festival_mis_sniff_recovers(self, data):
        state = self._format_tour(data / "metadata.psv", ["festival", "psv"]).run()
        assert state["datasets"][0]["format"] == "psv"

    def test_empty_filelist_exits(self, tmp_path):
        empty = tmp_path / "empty.psv"
        empty.write_text("")
        with pytest.raises(SystemExit, match="empty"):
            self._format_tour(empty, ["psv"]).run()

    def test_inconsistent_field_counts_rejected(self, tmp_path):
        ragged = tmp_path / "ragged.psv"
        ragged.write_text("basename|characters\na|b\nc|d|e\n")
        with pytest.raises(AssertionError, match="unscripted"):
            self._format_tour(ragged, ["psv", "tsv", "psv"]).run()


class TestColumnExhaustion:
    def test_two_column_headerless_filelist(self, tmp_path):
        filelist = tmp_path / "two.psv"
        filelist.write_text("f1|hello world\nf2|hi there\n")
        (tmp_path / "wavs").mkdir()
        answers = [
            "Two Col", "Test Runner", "info@everyvoice.ca", str(tmp_path),
            str(filelist), "yes", "psv", "no", "1", "0", "characters", "none",
            "no", "und", "keep", str(tmp_path / "wavs"), "no",
            "22050", "none", "twocol", "no", "skip", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert len(rows) == 2
        assert rows[0] == {"basename": "f1", "characters": "hello world",
                           "speaker": "speaker_0", "language": "und"}

    def test_header_row_dropped_when_confirmed(self, tmp_path):
        filelist = tmp_path / "hdr.psv"
        filelist.write_text("id|sentence\nf1|hello\n")
        (tmp_path / "wavs").mkdir()
        answers = [
            "Hdr", "Test Runner", "info@everyvoice.ca", str(tmp_path),
            str(filelist), "yes", "psv", "yes", "1", "0", "characters", "none",
            "no", "und", "keep", str(tmp_path / "wavs"), "no",
            "22050", "none", "hdr", "no", "skip", "yaml",
        ]
        rows = get_main_wizard_tour(ask=scripted_ask(answers)).run()["datasets"][0]["rows"]
        assert len(rows) == 1
        assert rows[0]["basename"] == "f1" and rows[0]["characters"] == "hello"


def _multi_answers(tmp_path):
    filelist = tmp_path / "multi.psv"
    filelist.write_text("basename|characters|speaker|language\n"
                        "f1|hello|spk1|eng\nf2|bonjour|spk2|fra\n")
    (tmp_path / "wavs").mkdir(exist_ok=True)
    return ["Multi", "Test Runner", "info@everyvoice.ca", str(tmp_path),
            str(filelist), "yes", "psv", "characters", "none", "yes", "yes",
            "keep", str(tmp_path / "wavs"), "no", "22050", "none", "multi", "no",
            "skip", "skip", "yaml"]


class TestDerivedModelFlags:
    def test_true_when_columns_vary(self, tmp_path):
        state = get_main_wizard_tour(ask=scripted_ask(_multi_answers(tmp_path))).run()
        config_dir = state["project_dir"] / "config"
        for name in ("everyvoice-text-to-spec.yaml", "everyvoice-text-to-wav.yaml"):
            model = yaml.safe_load((config_dir / name).read_text())["model"]
            assert model["multilingual"] is True and model["multispeaker"] is True

    def test_false_for_single_speaker_single_language(self, tmp_path, data):
        state = get_main_wizard_tour(
            ask=scripted_ask(lj_answers(tmp_path, data) + closing_answers())).run()
        fs2 = yaml.safe_load(
            (state["project_dir"] / "config" / "everyvoice-text-to-spec.yaml").read_text())
        assert fs2["model"]["multilingual"] is False
        assert fs2["model"]["multispeaker"] is False


class TestResumeEdgeCases:
    def test_replayed_invalid_answer_falls_back_to_live_prompt(self, tmp_path, data):
        session = tmp_path / "session.yaml"
        session.write_text(yaml.safe_dump({
            "tour": "everyvoice new-project", "version": "1.0",
            "responses": [["Name Step", "Resumed"], ["Contact Name Step", "Test Runner"],
                          ["Contact Email Step", "not-an-email"]],
        }))
        live = lj_answers(tmp_path, data)[2:]
        state = get_main_wizard_tour(ask=scripted_ask(live + closing_answers())).run(
            resume_from=session)
        assert state["name"] == "Resumed"
        assert state["contact_email"] == "info@everyvoice.ca"

    def test_resume_with_surplus_responses_completes(self, tmp_path, data):
        responses = [["q", a] for a in lj_answers(tmp_path, data) + closing_answers()]
        responses += [["Phantom Step", "zzz"], ["Another", "yyy"]]
        session = tmp_path / "session.yaml"
        session.write_text(yaml.safe_dump({"tour": "everyvoice new-project", "version": "1.0",
                                           "responses": responses}))
        state = get_main_wizard_tour(ask=scripted_ask([])).run(resume_from=session)
        assert (state["project_dir"] / "config").is_dir()


class TestPortablePaths:
    def _run(self, tmp_path, monkeypatch, wavs_answer):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "wavs" / "Common-Voice").mkdir(parents=True)
        (tmp_path / "fl.psv").write_text("basename|characters\nitem|hello\n")
        answers = [
            "Unittest", "Test Runner", "info@everyvoice.ca", ".", "fl.psv", "yes", "psv",
            "characters", "none", "no", "und", "keep", wavs_answer, "no",
            "22050", "none", "cv", "no", "skip", "yaml",
        ]
        state = get_main_wizard_tour(ask=scripted_ask(answers)).run()
        loaded = yaml.safe_load(
            (Path("Unittest") / "config" / "everyvoice-shared-data.yaml").read_text())
        return state, loaded

    def test_relative_wav_dir_rewritten_to_config_dir(self, tmp_path, monkeypatch):
        _, loaded = self._run(tmp_path, monkeypatch, "wavs/Common-Voice")
        assert loaded["source_data"][0]["data_dir"] == str(Path("../..") / "wavs" / "Common-Voice")
        assert loaded["save_dir"] == "../preprocessed"
        assert loaded["source_data"][0]["filelist"] == "../cv-filelist.psv"

    def test_absolute_wav_dir_stays_absolute(self, tmp_path, monkeypatch):
        wavs = tmp_path / "wavs" / "Common-Voice"
        _, loaded = self._run(tmp_path, monkeypatch, str(wavs))
        assert loaded["source_data"][0]["data_dir"] == str(wavs)

    def test_relocated_project_still_loads(self, tmp_path, monkeypatch):
        self._run(tmp_path, monkeypatch, "wavs/Common-Voice")
        moved = tmp_path / "elsewhere"
        moved.mkdir()
        shutil.move(str(tmp_path / "Unittest"), str(moved / "Unittest"))
        config = load_config_from_path(
            "text-to-spec", moved / "Unittest" / "config" / "everyvoice-text-to-spec.yaml")
        save_dir = Path(config["preprocessing"]["save_dir"])
        assert save_dir.is_absolute() and str(save_dir).startswith(str(moved))
        for ds in config["preprocessing"]["source_data"]:
            filelist = Path(ds["filelist"])
            assert filelist.is_absolute() and str(filelist).startswith(str(moved))
            assert filelist.exists()
            assert Path(ds["data_dir"]).is_absolute()
        training = Path(config["training"]["training_filelist"])
        assert training.is_absolute() and str(training).startswith(str(moved))


# ---------------------------------------------------------------------------
# parity with the JAX wizard


def _scripts(tmp_path, data) -> dict:
    """Answer scripts by name (each a function of the output directory)."""
    ood = tmp_path / "ood.txt"
    ood.write_text("A sentence.\nAnother sentence.\n")
    headerless = tmp_path / "noheader.psv"
    headerless.write_text("utt00000|hello world\nutt00001|more text\n")
    return {
        "lj": lambda out: lj_answers(out, data) + closing_answers(),
        "two datasets": lambda out: (
            lj_answers(out, data, more="yes")
            + dataset_answers(data / "metadata.psv", data / "wavs", name="second",
                              language="fra") + ["no"] + closing_answers(2)),
        "festival": lambda out: _base(out) + [
            str(data / "metadata.festival"), "yes", "festival", "characters",
            "lowercase + nfc normalization", "yes", "swahili-x", "custom", "sw-x", "keep",
            str(data / "wavs"), "44100", "normalization (-3.0dB)", "fest", "no",
            "hf", "owner/repo:texts.txt", "yaml"],
        "tsv": lambda out: _base(out) + [
            str(data / "language-col.tsv"), "yes", "tsv", "characters", "lowercase",
            "yes", "yes", "keep", str(data / "wavs"), "22050",
            "remove silence at start and end", "langcol", "no", "validation", "skip", "yaml"],
        "headerless": lambda out: _base(out) + [
            str(headerless), "yes", "psv", "no", "1", "0", "phones", "none", "no", "eng",
            "keep", str(data / "wavs"), "22050", "none", "nh", "no", "local", str(ood), "json"],
    }


def _run_both(tmp_path, answers_of) -> tuple:
    from everyvoice_tpu.wizard.main_tour import get_main_wizard_tour as jax_tour

    jax_state = jax_tour(ask=scripted_ask(answers_of(tmp_path / "jax"))).run()
    port_state = get_main_wizard_tour(ask=scripted_ask(answers_of(tmp_path / "port"))).run()
    return jax_state, port_state


def _project_files(project: Path) -> list:
    return sorted(str(p.relative_to(project)) for p in project.rglob("*") if p.is_file())


def _load(path: Path):
    text = path.read_text(encoding="utf8")
    return json.loads(text) if path.suffix == ".json" else yaml.safe_load(text)


@pytest.mark.parametrize("script", ["lj", "two datasets", "festival", "tsv", "headerless"])
def test_the_same_answers_write_the_jax_wizards_project(tmp_path, data, script):
    """Byte-equal filelists, config files that load to equal dicts."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_state, port_state = _run_both(tmp_path, _scripts(tmp_path, data)[script])
    jax_dir, port_dir = jax_state["project_dir"], port_state["project_dir"]
    files = _project_files(jax_dir)
    assert files == _project_files(port_dir)
    assert sum(f.endswith(".psv") for f in files) >= 1 and sum("config" in f for f in files) == 5
    for name in files:
        if name.endswith(".psv"):
            assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
        else:
            assert _load(port_dir / name) == _load(jax_dir / name), name


@pytest.mark.parametrize("kind", ["text-to-spec", "spec-to-wav", "text-to-wav"])
def test_each_package_loads_the_others_project(tmp_path, data, kind, monkeypatch):
    """The JAX loader validates the port's project, and the port's loader
    reads the JAX wizard's project to the same config as the port's."""
    from everyvoice_tpu.models.fs2.config import FastSpeech2Config
    from everyvoice_tpu.models.hifigan.config import HiFiGANConfig
    from everyvoice_tpu.models.styletts2.config import StyleTTS2Config

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_state, port_state = _run_both(tmp_path, _scripts(tmp_path, data)["two datasets"])
    name = f"config/everyvoice-{kind}.yaml"
    jax_class = {"text-to-spec": FastSpeech2Config, "spec-to-wav": HiFiGANConfig,
                 "text-to-wav": StyleTTS2Config}[kind]
    jax_of_port = jax_class.load_config_from_path(port_state["project_dir"] / name)
    assert jax_of_port.contact.contact_email == "info@everyvoice.ca"
    assert len(jax_of_port.preprocessing.source_data) == 2
    port_of_jax = load_config_from_path(kind, jax_state["project_dir"] / name)
    port_of_port = load_config_from_path(kind, port_state["project_dir"] / name)
    jax_root, port_root = str(jax_state["project_dir"]), str(port_state["project_dir"])
    assert json.loads(json.dumps(port_of_jax).replace(jax_root, port_root)) == port_of_port


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_each_package_resumes_the_others_session(tmp_path, data, saver, monkeypatch):
    """A session one package saves (Ctrl-C, "save and exit", midway)
    resumes in the other, whose tour then writes the project the saving
    package writes for the whole script."""
    from everyvoice_tpu.wizard.main_tour import get_main_wizard_tour as jax_tour

    tours = {"jax": jax_tour, "port": get_main_wizard_tour}
    resumer = "port" if saver == "jax" else "jax"
    answers = _scripts(tmp_path, data)["tsv"](tmp_path)
    cut = 9
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        tours[saver](ask=interruptable_ask(answers[:cut] + [INTERRUPT, "save and exit"])).run()
    session = next(tmp_path.glob("*-progress.yaml"))
    assert [r[1] for r in yaml.safe_load(session.read_text())["responses"]] == answers[:cut]
    resumed = tours[resumer](ask=scripted_ask(answers[cut:])).run(resume_from=session)
    shutil.move(str(resumed["project_dir"]), str(tmp_path / "resumed"))
    whole = tours[saver](ask=scripted_ask(answers)).run()["project_dir"]
    files = _project_files(whole)
    assert files == _project_files(tmp_path / "resumed")
    for name in files:
        if name.endswith(".psv"):
            assert (tmp_path / "resumed" / name).read_bytes() == (whole / name).read_bytes()
        else:
            # the same dicts, save for the project's own absolute paths
            got = json.dumps(_load(tmp_path / "resumed" / name)).replace(
                str(tmp_path / "resumed"), str(whole))
            assert json.loads(got) == _load(whole / name), name


def test_new_project_runs_as_a_process_on_stdin(tmp_path, data):
    """``python -m everyvoice_tpu_torch new-project`` fed its answers on
    standard input (a menu by its number) writes the project the scripted
    JAX tour writes for the same answers."""
    from everyvoice_tpu.wizard.main_tour import get_main_wizard_tour as jax_tour

    named = lj_answers(tmp_path / "jax", data) + closing_answers()
    numbered = list(named)
    for i, menu in ((6, "0"), (7, "0"), (8, "0"), (9, "1"), (10, "1"), (11, "0"), (14, "0"),
                    (16, "0"), (17, "0"), (18, "0")):
        numbered[i] = menu
    numbered[3] = str(tmp_path / "port")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    proc = subprocess.run([sys.executable, "-m", "everyvoice_tpu_torch", "new-project"],
                          input="\n".join(numbered) + "\n", cwd=tmp_path, capture_output=True,
                          text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    jax_dir = jax_tour(ask=scripted_ask(named)).run()["project_dir"]
    port_dir = tmp_path / "port" / "Test-Project"
    assert _project_files(port_dir) == _project_files(jax_dir)
    for name in _project_files(jax_dir):
        if name.endswith(".psv"):
            assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), name
        else:
            assert _load(port_dir / name) == _load(jax_dir / name), name


def test_text_helpers_match_the_jax_package(data):
    import regex

    from everyvoice_tpu.text.utils import guess_ipa_phones_in_text_lines as jax_guess
    from everyvoice_tpu.utils import read_festival as jax_read_festival
    from everyvoice_tpu.utils import sniff_and_return_filelist_data as jax_sniff
    from everyvoice_tpu_torch.text.utils import guess_ipa_phones_in_text_lines, is_sentence_final
    from everyvoice_tpu_torch.utils import read_festival, sniff_and_return_filelist_data

    terminal = regex.compile(r"\p{Sentence_Break=ST}|\p{Sentence_Break=AT}")
    differ = [cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF
              and is_sentence_final(chr(cp)) != bool(terminal.match(chr(cp)))]
    assert differ == []
    with pytest.raises(ValueError):
        is_sentence_final("!!")
    lines = list(PHONES) + ["ʃin1[}!]", "tʃ aɪ ˈpʰ"]
    assert guess_ipa_phones_in_text_lines(lines) == jax_guess(lines)
    for name in ("metadata.festival", "metadata.psv", "language-col.tsv"):
        assert sniff_and_return_filelist_data(data / name) == jax_sniff(data / name), name
    assert read_festival(data / "metadata.festival", record_limit=2) == jax_read_festival(
        data / "metadata.festival", record_limit=2)
    with pytest.raises(ValueError):
        read_festival(data / "metadata.psv")
