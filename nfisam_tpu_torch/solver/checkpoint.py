"""Checkpoint and resume of clique density models.

Counterpart of ``nfisam_tpu/solver/checkpoint.py``: every trained clique
flow is kept on disk under a *clique signature* (its variables, its
in-clique column order, its factors' text forms and content tags, and
the flow's configuration), so a restarted incremental run loads the
cliques whose signature is unchanged instead of training them, and a
clique whose factors changed misses.  The store is a directory of
``.npz`` files (one a clique) and a JSON manifest, in the JAX package's
layout: either package reads the other's store, and both compute the
same signature for the same clique.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

from ..flows.model import CliqueFlowModel
from ..flows.nsf import NSFConfig
from ..graph.bayes_tree import CliqueNode


def clique_signature(clique: CliqueNode, column_vars, factors,
                     cfg: NSFConfig) -> str:
    """Stable content hash identifying a trained clique model."""
    h = hashlib.sha256()
    h.update(",".join(sorted(str(v.name) for v in clique.frontal)).encode())
    h.update(b"|")
    h.update(",".join(sorted(str(v.name)
                             for v in clique.separator)).encode())
    h.update(b"|")
    h.update(",".join(str(v.name) for v in column_vars).encode())
    h.update(b"|")
    # a separator factor's string carries the content tag of its flow, so
    # a clique misses once a child's flow was retrained
    descs = []
    for f in factors:
        desc = str(f)
        tag = getattr(f, "content_tag", None)
        if tag is not None:
            desc += "#" + tag
        descs.append(desc)
    for d in sorted(descs):
        h.update(d.encode())
        h.update(b";")
    h.update(repr(cfg).encode())
    return h.hexdigest()[:24]


def content_tag(key, cfg: NSFConfig, shape) -> str:
    """A trained flow's content tag: its fit key, configuration and the
    (samples, dim) shape it was trained on, hashed as the JAX package
    hashes them (the shape as a Python tuple)."""
    return hashlib.sha256(
        np.asarray(key).tobytes() + repr(cfg).encode() +
        str(tuple(int(s) for s in shape)).encode()).hexdigest()[:16]


class CliqueModelStore:
    def __init__(self, directory: str, device) -> None:
        self.directory = directory
        self.device = device
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self.manifest = json.load(f)
        else:
            self.manifest = {}

    def _flush_manifest(self) -> None:
        with open(self._manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=1)

    def save(self, signature: str, model: CliqueFlowModel) -> None:
        arrays: Dict[str, np.ndarray] = {
            "mean": model.mean.cpu().numpy(),
            "std": model.std.cpu().numpy(),
        }
        for i, flow in enumerate(model.flow_params):
            for k, v in flow.items():
                arrays[f"flow{i}_{k}"] = v.detach().cpu().numpy()
        np.savez(os.path.join(self.directory, f"{signature}.npz"), **arrays)
        self.manifest[signature] = {
            "cfg": {
                "dim": model.cfg.dim,
                "num_knots": model.cfg.num_knots,
                "tail_bound": model.cfg.tail_bound,
                "hidden_dim": model.cfg.hidden_dim,
                "num_flows": model.cfg.num_flows,
                "circular": list(model.cfg.circular),
            },
            "circular_dim_list": [bool(c)
                                  for c in model.circular_dim_list],
            "aug_sep_dim": model.aug_sep_dim,
            "pad_dims": model.pad_dims,
            "content_tag": model.content_tag,
        }
        self._flush_manifest()

    def load(self, signature: str) -> Optional[CliqueFlowModel]:
        meta = self.manifest.get(signature)
        path = os.path.join(self.directory, f"{signature}.npz")
        if meta is None or not os.path.exists(path):
            return None
        with np.load(path) as data:
            num_flows = meta["cfg"]["num_flows"]
            flow_params = [{k.split("_", 1)[1]: data[k] for k in data.files
                            if k.startswith(f"flow{i}_")}
                           for i in range(num_flows)]
            return CliqueFlowModel.from_numpy(
                meta["cfg"], flow_params, data["mean"], data["std"],
                meta["circular_dim_list"], meta["aug_sep_dim"],
                meta.get("pad_dims", 0), self.device,
                content_tag=meta.get("content_tag", ""))

    def __contains__(self, signature: str) -> bool:
        return signature in self.manifest
