"""The port's scoring, training and CLI paths, its tooling (autotuner,
benchmark, health stamp, native encoder, bench_torch.py), the NN
library off the main path and chip_smoke import without JAX, the JAX
package, or the host packages the GPU machine lacks (pandas, h5py,
sklearn, yaml): run in a subprocess whose
import system refuses them, where a sweep is also enumerated. Further subprocesses run the port's CLI end to end, CSV to
results line, under the same refusal: as published, and with
``data_block_size`` and ``inter_block_retrieval`` set; and the ranks of
a 2-rank mesh run the multi-device dry run under it. Every module of
the run scripts (rat_tpu_torch.scripts) imports under it too. Each
subpackage of rat_tpu_torch exports the names of its rat_tpu
counterpart's ``__init__.py``, but for the omissions listed below;
save_hdf5 and embedding_table_shapes are held to the JAX package's."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "rat_tpu", "pandas", "h5py",
           "sklearn", "yaml")

import importlib.abc
import importlib.machinery

class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ModuleNotFoundError("blocked import: " + spec.name)

    def exec_module(self, module):
        pass

class Blocker:
    # a spec without an origin whose loader refuses: importing fails as
    # for a package that is not installed, and torch's probes of optional
    # packages (importlib.util.find_spec, then the spec's origin) skip it
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            return importlib.machinery.ModuleSpec(name, Refuse())
        return None

sys.meta_path.insert(0, Blocker())
"""

_BLOCKER = _BLOCK + """
import chip_smoke
import rat_tpu_torch
from rat_tpu_torch.data.loader import DataGenerator, h5_generator
from rat_tpu_torch.data.block_loader import DataBlockGenerator
from rat_tpu_torch.metrics import evaluate_metrics
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_optimizer, regularization_loss
from rat_tpu_torch.ops.bm25_score_chunk import bm25_score_chunk
from rat_tpu_torch.models import build_model, rat_m2_fast_forward
from rat_tpu_torch.retrieval import bm25_topk_retrieval
from rat_tpu_torch.utils import load_config
import rat_tpu_torch.convert
import rat_tpu_torch.cli.run_expid
import rat_tpu_torch.data.build
import rat_tpu_torch.data.synthetic
import rat_tpu_torch.features
import rat_tpu_torch.features.datasets
import rat_tpu_torch.retrieval.similarity
import rat_tpu_torch.engine.checkpoint
import rat_tpu_torch.parallel
import rat_tpu_torch.parallel.dryrun
import rat_tpu_torch.retrieval.sharded
import rat_tpu_torch.autotuner
import rat_tpu_torch.cli.benchmark
import rat_tpu_torch.cli.chip_health
import rat_tpu_torch.native
import rat_tpu_torch.ops.bench_kernel
import bench_torch
# the NN library off the main path, and PET's graphs
import rat_tpu_torch.nn.attention_lib
import rat_tpu_torch.nn.deep
import rat_tpu_torch.nn.feature_embedding
import rat_tpu_torch.nn.graph
import rat_tpu_torch.nn.interaction
from rat_tpu_torch.data.graph import PETGraphProcessor, batch_graphs
g = batch_graphs([PETGraphProcessor.build_instance_graph([[1, 2], [1, 3]], [1, 0])])
assert g["num_nodes"] == 5, g
# a sweep's enumeration reads and writes its YAML without PyYAML
import os, tempfile
from rat_tpu_torch.autotuner import enumerate_params, load_experiment_ids
from rat_tpu_torch.utils.yaml_subset import dump
tmp = tempfile.mkdtemp()
with open(os.path.join(tmp, "sweep.yaml"), "w") as fh:
    fh.write(dump({"base_expid": "e1",
                   "model_config": {"e1": {"model": "RAT_m2", "dataset_id": "ds1",
                                           "learning_rate": 1e-3}},
                   "dataset_config": {"ds1": {"data_format": "csv"}},
                   "tuner_space": {"learning_rate": [1e-3, 1e-4]}}))
ids = load_experiment_ids(enumerate_params(os.path.join(tmp, "sweep.yaml")))
assert len(ids) == 2 and all(i.startswith("e1_00") for i in ids), ids
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ok")
"""


def test_scoring_path_imports_without_blocked_packages():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


_CLI_RUN = _BLOCK + """
import os, runpy
work, repo = sys.argv[1], sys.argv[2]
os.chdir(work)
from rat_tpu_torch.data.synthetic import make_mltag_like
make_mltag_like("./data/demo", n_train=1500, n_valid=300, n_test=300, n_users=40,
                n_items=30, n_tags=12, seed=3)
os.makedirs("configs/demo")
for name in ("dataset_config.yaml", "model_config.yaml"):
    with open(os.path.join(repo, "configs", "demo", name)) as fh:
        text = fh.read().replace("    epochs: 20\\n", "    epochs: 2\\n" + sys.argv[3])
        text = text.replace("        topK: 5\\n", "        topK: 5\\n" + sys.argv[4])
    with open(os.path.join("configs", "demo", name), "w") as fh:
        fh.write(text)
sys.argv = ["run_expid", "--config", "./configs/demo",
            "--expid", "RAT_m2_demo_10fold_retrieval", "--gpu", "-1"]
runpy.run_module("rat_tpu_torch.cli.run_expid", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
with open("exps/demo/demo_10fold_retrieval/RAT_m2_demo_10fold_retrieval.csv") as fh:
    print(fh.read().strip())
"""


def _run_cli(tmp_path, model_lines="", retrieval_lines=""):
    out = subprocess.run([sys.executable, "-c", _CLI_RUN, str(tmp_path), REPO,
                          model_lines, retrieval_lines],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert "[exp_id] RAT_m2_demo_10fold_retrieval" in line and "[test] AUC: " in line
    return sorted(os.listdir(tmp_path / "data" / "demo_10fold_retrieval"))


def test_cli_runs_end_to_end_without_blocked_packages(tmp_path):
    assert "train.npy" in _run_cli(tmp_path)


def test_blocked_cli_runs_end_to_end_without_blocked_packages(tmp_path):
    """Three train blocks, each retrieving from the other two."""
    files = _run_cli(tmp_path, "    data_block_size: 600\n",
                     "        inter_block_retrieval: true\n")
    assert [f for f in files if f.startswith("train")] == [
        "train_part_0.npy", "train_part_1.npy", "train_part_2.npy"]
    assert len([f for f in files if f.startswith("retrieval_inter_")]) == 3


_SCRIPTS = _BLOCK + """
import importlib, pkgutil
import rat_tpu_torch.scripts
names = sorted(m.name for m in pkgutil.iter_modules(rat_tpu_torch.scripts.__path__))
for name in names:
    module = importlib.import_module("rat_tpu_torch.scripts." + name)
    assert callable(module.main), name
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print(" ".join(names))
"""


def test_scripts_import_without_blocked_packages():
    """Every module of rat_tpu_torch.scripts (one per JAX script, under
    its file name) imports with JAX, the JAX package and the host
    packages refused, and has a ``main``."""
    out = subprocess.run([sys.executable, "-c", _SCRIPTS], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == sorted(
        name[:-3] for name in os.listdir(os.path.join(REPO, "scripts"))
        if name.endswith(".py"))


def test_no_jax_or_rat_tpu_imports_in_port_sources():
    """Textual check of every module of the port, chip_smoke.py and the
    port's root scripts: none imports JAX, the JAX package, pandas,
    sklearn or PyYAML, and none imports h5py at module level."""
    files = [os.path.join(REPO, name) for name in
             ("chip_smoke.py", "bench_torch.py", "run_expid_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rat_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "flax", "optax", "rat_tpu", "pandas",
                                       "sklearn", "yaml"), (path, line)
                    # h5py only inside the functions that touch .h5 files
                    assert top != "h5py" or line[:1].isspace(), (path, line)


def test_mesh_workers_run_without_blocked_packages(tmp_path):
    """Each rank of a 2-rank gloo world refuses the packages, runs the
    dry run's worker (a train and an eval step, the checkpoint round
    trips, the dedup and mask variants on a 1x2 mesh), and has loaded
    none of them."""
    from torch_mesh_world import PRELUDE, run_world
    code = """
from rat_tpu_torch.parallel.dryrun import _worker
_worker(2)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
"""
    outs = run_world(code, 2, str(tmp_path), prelude=_BLOCK + PRELUDE)
    assert "mesh={'data': 1, 'model': 2}" in outs[0] and outs[0].strip().endswith("OK")


# ---- package-level names against the JAX package's ----------------------

def _jax_packages():
    top = os.path.join(REPO, "rat_tpu")
    return sorted(".".join(["rat_tpu"] + [p for p in os.path.relpath(root, top).split(os.sep)
                                          if p != "."])
                  for root, _, names in os.walk(top) if "__init__.py" in names)


JAX_PACKAGES = _jax_packages()
# the port's counterpart of a JAX package, where it is not the same path
# under rat_tpu_torch
PORT_PACKAGE = {"rat_tpu.ops.pallas": "rat_tpu_torch.ops"}
# names the port leaves out on purpose (ROADMAP, "Left out on purpose")
OMITTED = {
    # JAX sharding objects: the port's mesh is processes, one device each,
    # with torch.distributed groups and no sharding specs
    "rat_tpu.parallel": {"batch_sharding", "replicated_sharding", "state_sharding"},
    # the Pallas wrappers: rat_tpu_torch.ops exports the kernel modules,
    # whose names shadow bm25_score_chunk, so that no wrapper hides the
    # module that holds its launch count
    "rat_tpu.ops.pallas": {"fused_cross_intra_block", "cross_intra_block_reference",
                           "bm25_score_chunk", "bm25_score_chunk_pallas",
                           "bm25_score_chunk_reference"},
}


def _exported(path):
    """Public names an ``__init__.py`` binds at its top level: imported
    from its modules, assigned, or defined."""
    import ast
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def test_every_jax_package_is_listed():
    assert len(JAX_PACKAGES) == 14 and "rat_tpu.ops.pallas" in JAX_PACKAGES
    assert set(OMITTED) <= set(JAX_PACKAGES)


@pytest.mark.parametrize("package", JAX_PACKAGES)
def test_package_exports_jax_names(package):
    """Each name that the JAX package's ``__init__.py`` exports is an
    attribute of the port's package, but for the omissions above, which
    must be JAX exports that the port gives no callable of that name."""
    import importlib
    names = _exported(os.path.join(REPO, *package.split("."), "__init__.py"))
    port = importlib.import_module(
        PORT_PACKAGE.get(package, package.replace("rat_tpu", "rat_tpu_torch", 1)))
    omitted = OMITTED.get(package, set())
    assert omitted <= names, omitted - names
    assert sorted(n for n in names - omitted if not hasattr(port, n)) == []
    assert sorted(n for n in omitted if callable(getattr(port, n, None))) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_hdf5_appends_for_the_other_package(tmp_path, writer):
    """save_hdf5 appends two datasets to one file in a directory it
    creates; the other package's load_hdf5 reads each back equal, and
    with no key the first."""
    import numpy as np
    from rat_tpu.data import load_hdf5 as jax_load, save_hdf5 as jax_save
    from rat_tpu_torch.data import load_hdf5, save_hdf5
    save, load = (save_hdf5, jax_load) if writer == "port" else (jax_save, load_hdf5)
    rng = np.random.RandomState(3)
    a, b = rng.rand(5, 4), rng.randint(0, 9, (7,)).astype(np.int32)
    path = str(tmp_path / "new" / "dir" / "arrays.h5")
    save(a, path)
    save(b, path, key="indices")
    np.testing.assert_array_equal(load(path, key="data"), a)
    got = load(path, key="indices")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, b)
    np.testing.assert_array_equal(load(path), a)


def test_embedding_table_shapes_match_jax(tiny_feature_map):
    """The demo RAT_m2 (configs/demo) on a tiny three-field map, its flax
    weights carried into the port: the same set of row-shardable table
    shapes."""
    import jax
    import numpy as np
    from rat_tpu.models import build_model as jax_build
    from rat_tpu.parallel import embedding_table_shapes as jax_shapes
    from rat_tpu_torch.convert import params_from_jax
    from rat_tpu_torch.features import FeatureMap
    from rat_tpu_torch.models import build_model
    from rat_tpu_torch.parallel import embedding_table_shapes
    from rat_tpu_torch.utils import load_config
    params = load_config(os.path.join(REPO, "configs", "demo"),
                         "RAT_m2_demo_10fold_retrieval")
    variables = jax_build(tiny_feature_map, params).init(
        jax.random.PRNGKey(0), np.zeros((2, 6, 3), np.int32),
        np.zeros((2, 6), np.float32), train=False)
    want = jax_shapes(variables["params"])
    fm = FeatureMap(tiny_feature_map.dataset_id, tiny_feature_map.data_dir)
    fm.from_dict(tiny_feature_map.to_dict())
    model = build_model(fm, params)
    model.load_state_dict(params_from_jax(jax.device_get(variables["params"])))
    assert len(want) == 2      # the packed table and the wide tower's
    assert embedding_table_shapes(model) == want
