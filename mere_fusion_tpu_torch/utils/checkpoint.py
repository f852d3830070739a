"""Checkpoints of the port's own training state, with torch.save.

One file per step, ``<directory>/ckpt-<step>.pt``, holding whatever
state dict the trainer hands over (tensors, numbers, strings, lists and
dicts of them) and the step's metrics. A save writes to a temporary name and
renames it into place, so a crash never leaves a half-written checkpoint
under a real name; the newest ``max_keep`` are kept.

Two directory formats of served weights are read here as well:

- the JAX package's orbax checkpoints (its ``Checkpointer``: a manager root
  of numeric step directories, each ``<step>/default`` an OCDBT store of
  zarr arrays with a JSON ``_METADATA`` tree), by ``restore_orbax_raw``
  through ``tensorstore``, without JAX or orbax. ``tensorstore`` is imported
  when a directory is read; hosts without it (a serving card's machine)
  convert on a host that has it:
  ``python -m mere_fusion_tpu_torch.tools.convert_ckpt <family> <dir> <out>``;
- the port's converted directories (``tools/convert_ckpt.py``): a
  ``family.json`` as the JAX converter writes it and one weights-only
  ``weights.pt`` state dict under the port's module names
  (``save_converted``, ``load_converted``).
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

_NAME = re.compile(r"ckpt-(\d+)\.pt")
# the port's converted directory: family.json beside one state dict
FAMILY_JSON = "family.json"
WEIGHTS = "weights.pt"
# orbax's key_type: 1 a sequence index, 2 a dict key; empty containers and
# None leaves carry no array
_SEQUENCE = 1
_EMPTY = {"Dict": dict, "List": list, "Tuple": list, "None": lambda: None}


class Checkpointer:
    def __init__(self, directory: str, max_keep: int = 2):
        if max_keep < 1:
            raise ValueError(f"max_keep must be at least 1, got {max_keep}")
        self.directory = os.path.abspath(directory)
        self.max_keep = max_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def steps(self) -> list[int]:
        """Steps with a checkpoint on disk, oldest first."""
        found = (_NAME.fullmatch(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    @property
    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict, metrics: dict | None = None) -> str:
        """Write ``state`` (a state dict) for ``step``; returns the path."""
        out = self.path(step)
        tmp = f"{out}.{os.getpid()}.tmp"
        torch.save({"step": int(step), "state": state,
                    "metrics": {k: float(v) for k, v in (metrics or {}).items()}}, tmp)
        os.replace(tmp, out)
        for old in self.steps()[:-self.max_keep]:
            os.remove(self.path(old))
        return out

    def restore(self, step: int | None = None, map_location=None) -> dict:
        """The state dict saved for ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)["state"]

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX twin's API."""


def _orbax_step_dir(path: str, step: int | None) -> str:
    """The step directory of an orbax checkpoint: ``path`` itself when it is
    one, else ``step`` (default: the newest numeric step) of the manager
    root ``path``; orbax's unfinished ``*.orbax-checkpoint-tmp-*`` saves are
    skipped. Raises FileNotFoundError when there is none."""
    if step is None and os.path.isfile(os.path.join(path, "default", "_METADATA")):
        return path
    steps = sorted(int(n) for n in os.listdir(path)
                   if n.isdigit() and os.path.isdir(os.path.join(path, n)))
    if step is None and steps:
        step = steps[-1]
    if step is None or step not in steps:
        raise FileNotFoundError(f"no checkpoint in {path}"
                                + (f" at step {step}" if step is not None else ""))
    return os.path.join(path, str(step))


def restore_orbax_raw(path: str, step: int | None = None):
    """The tree of the JAX package's orbax checkpoint at ``path`` (a manager
    root or one step directory), as its ``Checkpointer.restore_raw`` gives
    it: nested dicts and lists (NamedTuples and tuples, such as optax
    states, as dicts and lists), ``scalar`` leaves as Python numbers, leaves
    without an array (None, empty containers) as None, ``{}`` or ``[]``,
    and every array as numpy, except bfloat16 ones: numpy has no bfloat16,
    so those come back as torch.bfloat16 tensors made from the same bits.

    Reads through ``tensorstore`` (imported here; ImportError naming it when
    absent) and needs no JAX. Raises FileNotFoundError when ``path`` holds
    no checkpoint."""
    item = os.path.join(_orbax_step_dir(path, step), "default")
    meta_path = os.path.join(item, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(f"no orbax tree metadata at {meta_path}")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {path!r} needs the tensorstore package, which "
            "is not installed here: convert it on a host that has tensorstore with "
            "python -m mere_fusion_tpu_torch.tools.convert_ckpt <family> <dir> <out_dir>, "
            "and serve out_dir") from e
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise ValueError(f"{item!r} is not the JAX Checkpointer's layout (zarr v2 arrays "
                         "in one OCDBT store)")
    kvstore = {"driver": "ocdbt", "base": {"driver": "file", "path": os.path.abspath(item) + "/"}}

    def read(name: str):
        spec = {"driver": "zarr", "kvstore": kvstore, "path": name}
        return ts.open(spec, open=True, read=True).result().read().result()

    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind in _EMPTY or value.get("skip_deserialize"):
            leaf = _EMPTY.get(kind, lambda: None)()
        else:
            arr = read(".".join(k["key"] for k in keys))
            if kind == "scalar":
                leaf = arr.item()
            elif arr.dtype.name == "bfloat16":
                leaf = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(
                    torch.bfloat16)
            else:
                leaf = np.asarray(arr)
        node = tree
        for k, nxt in zip(keys, keys[1:] + [None]):
            key = int(k["key"]) if k["key_type"] == _SEQUENCE else k["key"]
            if nxt is None:
                node[key] = leaf
            else:
                node = node.setdefault(key, {})
    return _as_lists(tree)


def _as_lists(tree: dict):
    """``tree``'s dicts keyed by sequence indices as lists, in index order."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            return [out[i] for i in sorted(out)]
        return out

    return walk(tree)


def is_converted(path: str) -> bool:
    """Whether ``path`` is a directory the port's convert_ckpt wrote."""
    return os.path.isfile(os.path.join(path, WEIGHTS))


def save_converted(out_dir: str, family: str, state: dict, meta: dict, source: str) -> None:
    """Write a converted directory: ``family.json`` (``family``, ``source``
    and the metadata's entries, as the JAX converter writes it) and the
    state dict as ``weights.pt``."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, WEIGHTS)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    with open(os.path.join(out_dir, FAMILY_JSON), "w") as f:
        json.dump({"family": family, "source": os.path.abspath(source), **meta}, f)


def read_family_json(path: str) -> dict:
    """``path``'s family.json (the JAX converter's or the port's), or {}."""
    fam = os.path.join(path, FAMILY_JSON)
    if not os.path.isfile(fam):
        return {}
    with open(fam) as f:
        return json.load(f)


def load_converted(path: str) -> tuple[dict, dict]:
    """(state dict on the CPU, family.json's entries) of a converted
    directory."""
    state = torch.load(os.path.join(path, WEIGHTS), map_location="cpu", weights_only=True)
    return state, read_family_json(path)
