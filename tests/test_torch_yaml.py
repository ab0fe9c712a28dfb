"""``models/yaml_lite``, the port's config reader, against PyYAML's
``safe_load``: every config of the repo, and a document with the rest of
what it reads, give equal values; what it does not read raises."""

from pathlib import Path

import pytest
import yaml

from caiman_asr_tpu_torch.models import config, yaml_lite

REPO = Path(__file__).resolve().parents[1]

DOC = """
# a comment
a: &A
  x: 1      # trailing
  y: "q # not a comment"
  z: 'it''s'
b:
  !!merge <<: *A
  y: 2
c: [1, 2.5, "s", yes, off, ~, .inf, -.inf, 1e-5, 1.5e+3, abc, 007, 0x1F, -0b101, 08, +.5]
d:
  - old: "x"
    new: y
  - plain
  - [1, 2]
  -
    k: v
e: {k: 1, m: [a, b], 'q': "r"}
f:
g: "esc\\t\\"\\u00e9\\x41"
h: http://x.y/z
"i j": -3
list_at_key_indent:
- 1
- two
over_lines: [" ", "a", # a comment
             'b]', "c"
  ,
             {k: [1,
                  2]}]
m: &M {x: 1,
  y: "}"}
n: *M
o: a[0] b{
"""


@pytest.mark.parametrize("path", sorted((REPO / "configs").glob("*.yaml")), ids=lambda p: p.name)
def test_every_config_reads_as_pyyaml_reads_it(path):
    assert yaml_lite.safe_load(path.read_text()) == yaml.safe_load(path.read_text())


def test_the_rest_of_what_it_reads():
    assert yaml_lite.safe_load(DOC) == yaml.safe_load(DOC)
    assert yaml_lite.safe_load("") is None


@pytest.mark.parametrize("text", ["a: |\n  block\n", "a: !!python/object x\n", "a: *nope\n",
                                  "a:\n\tb: 1\n", "%YAML 1.1\na: 1\n", 'a: "open\n',
                                  "a: [1,\n  2\n"])
def test_what_it_does_not_read_raises(text):
    with pytest.raises(ValueError):
        yaml_lite.safe_load(text)


def test_load_config_reads_the_same_without_pyyaml(monkeypatch):
    for path in sorted((REPO / "configs").glob("*.yaml")):
        want = config.load_config(path)
        monkeypatch.setitem(__import__("sys").modules, "yaml", None)
        assert config.load_config(path) == want
        monkeypatch.undo()
