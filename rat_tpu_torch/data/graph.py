"""PET graph preprocessing (port of rat_tpu.data.graph, numpy only).

Per-instance bipartite graphs of instance and feature nodes, with
labels (the target instance's label id is 2 = [MASK]), edges in both
directions and global feature-id offsetting. Graphs are plain dicts of
numpy arrays (edge lists and node attributes), which
rat_tpu_torch.nn.graph.PET_Layer consumes after ``batch_graphs``
(a disjoint union with offsets, as ``dgl.batch`` forms it).
"""

import numpy as np


class PETGraphProcessor:
    @staticmethod
    def convert_indices(X, feature_specs):
        """Offset each field's ids into one global id space."""
        offset = 0
        X = X.copy()
        for _, feature_spec in feature_specs.items():
            X[..., feature_spec["index"]] += offset
            offset += feature_spec["vocab_size"]
        return X

    @staticmethod
    def build_instance_graph(X_i, y_i):
        """One bipartite instance/feature graph per (target + neighbors)
        group.

        Contract (reference PETGraphProcessor,
        fuxictr/datasets/data_utils.py:150-186): rows of X_i are
        instance nodes, distinct (globally-offset) feature values are
        feature nodes, and every table cell contributes an undirected
        instance<->feature edge stored as both directions. The target's
        label is replaced by the [MASK] embedding id 2, and feature
        nodes carry label 2 as well (unused downstream). Node
        numbering is compact: the T instances take ids 0..T-1, the
        sorted distinct feature values follow.

        X_i: [F] or [(1+K), F]; y_i: scalar or [(1+K)]. Returns a dict
        graph: edge_src/edge_dst/label/original_node_ids/is_target/
        is_instance/is_feature/num_nodes.
        """
        X_i = np.asarray(X_i)
        labels = np.atleast_1d(np.array(y_i, copy=True))
        labels[0] = 2  # mask the target's own label
        n_inst = labels.shape[0]

        # compact renumbering in one pass: rank of each distinct value
        # (+ the instance-block offset) is that cell's feature node id
        feat_vals, inv = np.unique(X_i.reshape(-1), return_inverse=True)
        feat_of_cell = (inv + n_inst).astype(np.int64)
        inst_of_cell = np.repeat(np.arange(n_inst), X_i.shape[-1])
        num_nodes = n_inst + len(feat_vals)

        node_ids = np.arange(num_nodes)
        return {
            # feature->instance edges first, then the reverse direction
            "edge_src": np.concatenate((feat_of_cell, inst_of_cell)).astype(np.int32),
            "edge_dst": np.concatenate((inst_of_cell, feat_of_cell)).astype(np.int32),
            "label": np.concatenate(
                [labels, np.full(num_nodes - n_inst, 2)]).astype(np.int64),
            # instance slots hold offset-removed ids (negative by
            # construction, never looked up); feature slots hold the
            # raw global feature id for the embedding gather
            "original_node_ids": np.concatenate(
                [np.arange(n_inst) - n_inst, feat_vals]).astype(np.int64),
            "is_target": node_ids < 1,
            "is_instance": node_ids < n_inst,
            "is_feature": node_ids >= n_inst,
            "num_nodes": num_nodes,
        }


def batch_graphs(graphs):
    """Disjoint union of dict graphs (dgl.batch equivalent): node ids of
    graph i are offset by the total node count of graphs 0..i-1."""
    out = {"edge_src": [], "edge_dst": [], "label": [], "original_node_ids": [],
           "is_target": [], "is_instance": [], "is_feature": []}
    offset = 0
    graph_sizes = []
    for g in graphs:
        out["edge_src"].append(g["edge_src"] + offset)
        out["edge_dst"].append(g["edge_dst"] + offset)
        for k in ("label", "original_node_ids", "is_target",
                  "is_instance", "is_feature"):
            out[k].append(g[k])
        graph_sizes.append(g["num_nodes"])
        offset += g["num_nodes"]
    batched = {k: np.concatenate(v) for k, v in out.items()}
    batched["num_nodes"] = offset
    batched["graph_sizes"] = np.asarray(graph_sizes)
    return batched
