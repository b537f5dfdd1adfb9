"""The port's YAML reader and writer (everyvoice_tpu_torch/utils/yaml_lite.py)
against PyYAML: generated config trees read back as ``yaml.safe_load``
reads ``yaml.safe_dump``'s output, ``yaml.safe_load`` reads the port's
output back as the tree, hand-written documents (comments, flow
collections, quoting, YAML 1.1 scalars) load the same, and what the reader
does not support raises with its line. Exact equality (NaN compared as
NaN)."""

import datetime
import math

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from everyvoice_tpu_torch.utils import load_config_file, write_config_file, yaml_lite

TRICKY = ["yes", "No", "ON", "1e-5", "1.0e-5", "null", "~", "", "a: b", "#x", " lead",
          "trail ", "0o17", "017", "0x1f", "1_000", "1:30", ".inf", "-.Inf", ".NaN",
          "2024-01-02", "- x", "[1]", "{a: 1}", "'q'", '"q"', "a #b", "...", "---", "=",
          "<<", "@x", "`x", "%x", "!x", "&x", "*x", "|", ">", "?", "é", "ü ü", "\t",
          "a\nb", "x\n", "tab\there", "\x7f", "\x85", "\u2028x", "\ufeffa", "\xa0"]
KEYS = st.text(st.characters(blacklist_categories=("Cs", "Cc", "Zl", "Zp"),
                             blacklist_characters="\x85"), max_size=12) | st.sampled_from(TRICKY[:40])
SCALARS = (st.none() | st.booleans() | st.integers(-10**12, 10**12)
           | st.floats(allow_nan=False, width=64) | st.sampled_from(TRICKY)
           | st.text(st.characters(blacklist_categories=("Cs",)), max_size=20))
TREES = st.recursive(SCALARS, lambda children: st.lists(children, max_size=4)
                     | st.dictionaries(KEYS, children, max_size=4), max_leaves=25)
CONFIG_TREES = st.dictionaries(KEYS, TREES, max_size=5)


def same(a, b) -> bool:
    """Equality with NaN equal to NaN and types kept apart (1 != 1.0 != True)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(CONFIG_TREES)
def test_reads_what_safe_dump_writes(tree):
    text = yaml.safe_dump(tree, allow_unicode=True, sort_keys=False)
    assert same(yaml_lite.load(text), yaml.safe_load(text)), text


@settings(max_examples=300, deadline=None, suppress_health_check=list(HealthCheck))
@given(CONFIG_TREES)
def test_safe_load_reads_back_what_it_writes(tree):
    text = yaml_lite.dump(tree)
    assert same(yaml.safe_load(text), tree), text
    assert same(yaml_lite.load(text), tree), text


HAND_WRITTEN = {
    "comments": "# a project\na: 1  # one\nb: x#y\n# end\n",
    "flow": "a: [1, 3, 5]\nb: [[1, 3, 5], [1, 3, 5]]\nc: {}\nd: []\ne: {x: 1, 'y': [a, b], z}\n",
    "flow across lines": "sox_effects: [\n  [channels, '1'],  # mono\n  [rate, 22050]\n]\n",
    "json-like": '{"a": 1, "b": [true, null, 2.5], "c": {"d": "e"}}\n',
    "quoting": "a: 'it''s'\nb: \"tab\\tnew\\nline \\u00e9 \\x41\"\nc: 'multi\n  line'\n",
    "double quoted continuation": 'a: "one \\\n  two"\n',
    "indentless sequence": "a:\n- 1\n- 2\nb:\n  - x\n  - y: 1\n    z: 2\n",
    "nested sequences": "- - 1\n  - 2\n- - 3\n- a: 1\n  b: [2]\n-\n  c: 3\n- \n",
    "yaml 1.1 scalars": ("a: yes\nb: Off\nc: 1e-5\nd: 1.0e-5\ne: 0o17\nf: 017\ng: 0x1f\n"
                         "h: 1_000\ni: 1:30\nj: .inf\nk: -.Inf\nl: .NaN\nm: ~\nn: Null\n"
                         "o: 2024-01-02\np: 2001-12-14 21:59:43.10 -5\nq: +12\nr: 0b101\n"
                         "s: 1.5e+3\nt: 190:20:30.15\nu: y\nv: nUll\nw: 08\n"),
    "plain across lines": "a: one two\n  three\n\n  four\nb: -x\nc: :x\nd: a:b\n",
    "key spacing": "key   : v\n'quoted key': 1\n\"dq\": 2\n1: int key\ntrue: bool key\n",
    "document markers": "--- \na: 1\n...\n",
    "empty": "",
    "only comments": "# nothing\n\n",
    "top-level scalar": "hello world\n",
    "null values": "a:\nb: ~\nc: null\nd: ''\n",
    "wizard project": ("contact:\n  contact_name: A B\n  contact_email: a@b.org\n"
                       "path_to_preprocessing_config_file: everyvoice-shared-data.yaml\n"
                       "training:\n  training_filelist: ../preprocessed/training_filelist.psv\n"
                       "  logger:\n    save_dir: ../logs_and_checkpoints\n"),
    "crlf": "a: 1\r\nb:\r\n- x\r\n",
    "explicit keys": "? ''\n: null\n? 'a\n\n  b'\n: - 1\n  - 2\nc:\n- ? k\n  : x: 1\n- ? j\n",
}


@pytest.mark.parametrize("name", sorted(HAND_WRITTEN))
def test_hand_written_documents_load_as_pyyaml_loads_them(name):
    text = HAND_WRITTEN[name]
    assert same(yaml_lite.load(text), yaml.safe_load(text))


def test_scalars_resolve_as_yaml_1_1():
    got = yaml_lite.load(HAND_WRITTEN["yaml 1.1 scalars"])
    assert got["a"] is True and got["b"] is False and got["c"] == "1e-5"
    assert got["d"] == 1.0e-5 and got["e"] == "0o17" and got["f"] == 15
    assert got["g"] == 31 and got["h"] == 1000 and got["i"] == 90
    assert got["j"] == math.inf and math.isnan(got["l"]) and got["m"] is None
    assert got["o"] == datetime.date(2024, 1, 2)


UNSUPPORTED = {
    "anchor": ("a: 1\nb: &x 2\n", 2),
    "alias": ("a: *x\n", 1),
    "tag": ("a: 1\nb: 2\nc: !!str 3\n", 3),
    "literal block scalar": ("a: |\n  x\n", 1),
    "folded block scalar": ("a:\n  b: >\n    x\n", 2),
    "second document": ("a: 1\n---\nb: 2\n", 2),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "merge key": ("<<: {a: 1}\n", 1),
    "mapping in a plain value": ("a: b: c\n", 1),
    "bad indentation": ("a: 1\n  b: 2\n", 2),
    "unclosed quote": ("a: 1\nb: 'x\n", 2),
    "tab indentation": ("a:\n\tb: 1\n", 2),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_constructs_raise_with_their_line(name):
    text, line = UNSUPPORTED[name]
    with pytest.raises(ValueError, match=f"YAML line {line}:"):
        yaml_lite.load(text)


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_config_file_round_trip_matches_the_jax_writer(tmp_path, suffix):
    from everyvoice_tpu.utils import load_config_file as jax_load
    from everyvoice_tpu.utils import write_config_file as jax_write

    data = {"a": [1, 2.5, None], "b": {"c": "yes", "d": "ü"}, "e": True}
    write_config_file(tmp_path / f"port{suffix}", data)
    jax_write(tmp_path / f"jax{suffix}", data)
    assert jax_load(tmp_path / f"port{suffix}") == data
    assert load_config_file(tmp_path / f"jax{suffix}") == data
    if suffix == ".json":
        assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
