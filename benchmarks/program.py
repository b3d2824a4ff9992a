"""The benchmark's side of the program under test, rat_tpu_torch: its
feature map and data generators built from a configuration file, and a
Trainer whose hooks let a window end at a batch boundary, name the
layers in a trace, and read the program's own counters. Nothing here
changes what the program computes."""

import contextlib

import torch

from rat_tpu_torch.data.loader import DataGenerator
from rat_tpu_torch.engine.trainer import Trainer
from rat_tpu_torch.features import FeatureMap
from rat_tpu_torch.ops import bm25_topk as k2

#: model keys of a configuration file that the Trainer reads
_NOT_PARAMS = ("name", "source", "mirrors", "experiment", "reference", "dataset",
               "reduced_from", "assumed", "rehearsal", "matmul_precision")


def feature_map(cfg, vocab):
    """The FeatureMap of the configuration's categorical fields."""
    fm = FeatureMap(cfg["dataset_id"], ".")
    for i, (name, size) in enumerate(vocab.items()):
        fm.feature_specs[name] = {"source": "", "type": "categorical",
                                  "vocab_size": size, "index": i}
    fm.num_fields = len(vocab)
    fm.num_features = sum(vocab.values())
    fm.input_length = len(vocab)
    return fm


def retrieval_configs(cfg):
    """The dataset's retrieval block with its columns resolved to
    indices, as the CLI resolves them."""
    rc = dict(cfg["dataset"]["retrieval"])
    names = list(cfg["dataset"]["fields"])
    rc["used_col_indices"] = [names.index(c) for c in rc["used_cols"]]
    rc["exact_match_col_indices"] = [rc["used_cols"].index(c)
                                     for c in rc["exact_match_cols"]] or None
    return rc


def generator(cfg, fm, batch_size, device, rows, pool=None, shuffle=False):
    """A DataGenerator of ``rows``: X-fold self-retrieval without a pool,
    else retrieval against ``pool`` (the train split, as the CLI names
    it)."""
    return DataGenerator(data_array=rows, pool_array=pool, batch_size=batch_size,
                         shuffle=shuffle, feature_map=fm,
                         retrieval_configs=retrieval_configs(cfg),
                         retrieval_pool_fname="self" if pool is None else "train",
                         retrieval_augmented=True, device=device)


def params(cfg, batch_size, seed, model_root):
    """The experiment's parameters as the Trainer reads them."""
    p = {k: v for k, v in cfg.items() if k not in _NOT_PARAMS}
    p.update(batch_size=batch_size, seed=seed, model_root=model_root)
    return p


class _Graphs(dict):
    """The Trainer's captured step graphs, counting each graph's replays
    (``StepGraph.replays``) by kind as the Trainer lets it go."""

    def __init__(self, replays):
        super().__init__()
        self.replays = replays

    def _count(self, graph):
        if graph is not None:
            self.replays[graph.kind] = self.replays.get(graph.kind, 0) + graph.replays

    def pop(self, key, *default):
        graph = super().pop(key, *default)
        self._count(graph)
        return graph

    def __setitem__(self, key, graph):
        self._count(self.get(key))
        super().__setitem__(key, graph)

    def close(self):
        for graph in self.values():
            self._count(graph)
        self.clear()


class BenchTrainer(Trainer):
    """The program's Trainer, with:

    - ``on_batch`` called after each batch's bookkeeping (so a window can
      stop the fit at a batch boundary, through the Trainer's own stop
      flag, and start or stop a trace);
    - ``span``, a context around each evaluation (a trace's span);
    - ``graph_replays``, the replays of every step graph by kind, read
      from each graph as the Trainer drops it;
    - ``eval_state`` and ``eval_pred``: the model's state dict (a copy on
      the device) as the latest evaluation or prediction began, and the
      predictions it returned."""

    def __init__(self, *args, **kwargs):
        self.graph_replays = {}
        self.on_batch = None
        self.span = contextlib.nullcontext
        self.eval_state = self.eval_pred = None
        super().__init__(*args, **kwargs)

    @property
    def _graphs(self):
        return self._bench_graphs

    @_graphs.setter
    def _graphs(self, graphs):
        old = self.__dict__.get("_bench_graphs")
        if old is not None:
            old.close()
        self._bench_graphs = _Graphs(self.graph_replays)
        for key, graph in graphs.items():
            self._bench_graphs[key] = graph

    def replays(self):
        """{kind: replays} so far, the graphs alive included."""
        out = dict(self.graph_replays)
        for graph in self._bench_graphs.values():
            out[graph.kind] = out.get(graph.kind, 0) + graph.replays
        return out

    def on_batch_end(self, batch):
        super().on_batch_end(batch)
        if self.on_batch is not None:
            self.on_batch(self)

    def evaluate(self, data_gen, data=None):
        with self.span("evaluate"):
            return super().evaluate(data_gen, data)

    def _eval_collect(self, data_gen, data=None):
        state = {n: t.detach().clone() for n, t in self.model.state_dict().items()}
        pred, true = super()._eval_collect(data_gen, data)
        self.eval_state, self.eval_pred = state, pred
        return pred, true


def load_weights(trainer, weights):
    """Put the benchmark's weights into the trainer's model (strict: the
    names and shapes must be the model's)."""
    trainer.load_model_state(dict(weights))


def k2_launches():
    """K2's launch counter."""
    return k2.launches


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
