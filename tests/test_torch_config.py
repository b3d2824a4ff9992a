"""The port's YAML reader (rat_tpu_torch/utils/yaml_subset.py) against
PyYAML's ``safe_load``: every file under configs/, hand-written cases
of each construct and scalar rule of the subset, and the constructs
outside it, which must raise. Then ``load_config`` against the JAX
package's for every experiment in configs/."""

import glob
import math
import os

import pytest
import yaml

from rat_tpu.utils import load_config as jax_load_config
from rat_tpu_torch.utils import load_config
from rat_tpu_torch.utils.yaml_subset import safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                recursive=True))


def _same(a, b):
    """Equal, with NaN equal to NaN and bools not equal to ints."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_config_files_read_as_pyyaml_reads_them(path):
    with open(path) as fh:
        text = fh.read()
    assert _same(safe_load(text), yaml.safe_load(text))


CASES = {
    "scalars_yaml11": (
        "a: 0.\nb: 1e-3\nc: 1.0e-3\nd: 1.e-4\ne: 1.0e5\nf: .5\ng: -.inf\nh: .NaN\n"
        "i: 3.\nj: +5\nk: -0\nl: 010\nm: 0x1F\nn: 0b101\no: 1_000\np: 1:30\n"
        "q: 1:30.5\nr: 0.001\ns: 2021\n"),
    "bools_and_nulls": (
        "a: true\nb: False\nc: yes\nd: No\ne: on\nf: OFF\ng: ~\nh: null\ni: Null\n"
        "j:\nk: y\nl: TRUE\n"),
    "strings": (
        "a: plain words here\nb: 'single # not a comment'\nc: \"double\\ttab \\u00e9\"\n"
        "d: 'it''s'\ne: it's plain # a comment\nf: \"\"\ng: ''\nh: ./data/x.csv\n"
        "i: a:b\nj: RAT_m2_demo\nk: '10'\nl: \"yes\"\n"),
    "block_collections": (
        "# leading comment\nBase:\n    model_root: ./exps/\n    metrics: [AUC, logloss]\n"
        "\n    nested:\n        deeper: 1\n    empty:\nexp:\n    seq:\n    - a\n"
        "    - 2\n    indented:\n        -   x: 1\n            y: [1, 2]\n"
        "        -   z\n        -\n            w: 3\n        - - n1\n          - n2\n"),
    "flow_collections": (
        "a: []\nb: {}\nc: [1, 2.5, x, 'q', \"d\", [n, [m]], {k: v}]\n"
        "d: {dtype: float, name: label}\ne: {x: , y}\nf: [a, b, ]\n"
        "g: {a: [1,\n        2],\n     b: c}  # trailing comment\n"
        "h:\n- {active: true, dtype: str, name: genre_ids,\n    type: sequence}\n"
        "- [p, q,\n   r]\n"),
    "keys": "1: int key\ntrue: bool key\n'quoted key': v\nkey with spaces: v\n",
    "top_level_list": "- a\n- b: 1\n  c: 2\n- [x]\n",
    "top_level_scalar": "just a scalar\n",
    "comments_only": "# nothing\n\n   # here\n",
    "empty": "",
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_hand_written_cases_match_pyyaml(name):
    text = CASES[name]
    assert _same(safe_load(text), yaml.safe_load(text)), (safe_load(text),
                                                          yaml.safe_load(text))


UNSUPPORTED = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "literal_block_scalar": "a: |\n  text\n",
    "folded_block_scalar": "a: >\n  text\n",
    "document_marker": "---\na: 1\n",
    "directive": "%YAML 1.1\n---\na: 1\n",
    "complex_key": "? a\n: 1\n",
    "timestamp": "a: 2001-12-14\n",
    "merge_key": "<<: {a: 1}\n",
    "multi_line_plain": "a: b\n  c\n",
    "multi_line_flow_plain": "a: [x\n  y]\n",
    "multi_line_quoted": "a: 'x\n  y'\n",
    "tab_indent": "a:\n\tb: 1\n",
    "mapping_in_plain": "a: b: c\n",
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_constructs_outside_the_subset_raise_naming_the_line(name):
    with pytest.raises(ValueError, match=r"YAML line \d+"):
        safe_load(UNSUPPORTED[name])


def _expids():
    out = []
    for path in CONFIG_FILES:
        if os.path.basename(path) == "model_config.yaml":
            with open(path) as fh:
                out += [(os.path.dirname(path), k) for k in yaml.safe_load(fh)
                        if k != "Base"]
    return out


@pytest.mark.parametrize("config_dir,expid", _expids(),
                         ids=lambda v: os.path.relpath(v, REPO) if os.sep in v else v)
def test_load_config_matches_jax_for_every_experiment(config_dir, expid):
    assert _same(load_config(config_dir, expid), jax_load_config(config_dir, expid))
