"""The port's scoring, training and CLI paths, its tooling (autotuner,
benchmark, health stamp, native encoder, bench_torch.py), the NN
library off the main path and chip_smoke import without JAX, the JAX
package, or the host packages the GPU machine lacks (pandas, h5py,
sklearn, yaml): run in a subprocess whose
import system refuses them, where a sweep is also enumerated. Further subprocesses run the port's CLI end to end, CSV to
results line, under the same refusal: as published, and with
``data_block_size`` and ``inter_block_retrieval`` set; and the ranks of
a 2-rank mesh run the multi-device dry run under it. Every module of
the run scripts (rat_tpu_torch.scripts) imports under it too."""

import os
import subprocess
import sys

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
