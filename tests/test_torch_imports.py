"""The port's scoring and training paths and chip_smoke import without
JAX, the JAX package, or the host packages the GPU machine lacks
(pandas, h5py, sklearn, yaml): run in a subprocess whose import system
refuses them."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = """
import sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "rat_tpu", "pandas", "h5py",
           "sklearn", "yaml")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Blocker())
import chip_smoke
import rat_tpu_torch
from rat_tpu_torch.data.loader import DataGenerator, h5_generator
from rat_tpu_torch.engine import Trainer
from rat_tpu_torch.engine.optim import get_optimizer, regularization_loss
from rat_tpu_torch.ops.bm25_score_chunk import bm25_score_chunk
from rat_tpu_torch.models import build_model, rat_m2_fast_forward
from rat_tpu_torch.retrieval import bm25_topk_retrieval
from rat_tpu_torch.utils import load_config
import rat_tpu_torch.convert
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


def test_no_jax_or_rat_tpu_imports_in_port_sources():
    """Textual check of every module of the port and chip_smoke.py."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rat_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            for line in fh:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    top = words[1].split(".")[0]
                    assert top not in ("jax", "flax", "optax", "rat_tpu"), \
                        (path, line)
