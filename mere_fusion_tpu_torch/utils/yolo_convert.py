"""ultralytics YOLOv10 checkpoint → the port's YoloV10 state dict, without
ultralytics.

Port of mere_fusion_tpu/utils/yolo_convert.py. The reference loads
``yolov10x.pt`` through the ultralytics package (yolo_opencv.py:42); those
files pickle the whole ultralytics model object, so a plain ``torch.load``
fails without the package. ``load_ultralytics_state_dict`` recovers the
tensors anyway: a tolerant unpickler puts a stub class in place of any import
it cannot resolve, the pickled ``nn.Module`` graph lands as stub objects whose
``__dict__`` still holds torch's ``_parameters`` / ``_buffers`` /
``_modules``, and a recursive walk rebuilds the flat state dict.

The port's modules carry ultralytics' names, so ``convert_yolo`` only drops
the one-to-many training head (``cv2``/``cv3`` module lists of the Detect
layer) and the constant DFL conv, and casts the half-precision tensors the
files hold to float32; ``check_yolo_state`` names every key or shape that
does not fit the model.
"""
from __future__ import annotations

import io
import pickle
import re
import types
from typing import Any, Mapping

import torch

# Detect-layer one-to-many heads look like "model.23.cv2.0. ..." (a digit
# right after cv2/cv3); C2f's plain cv2 conv ("model.2.cv2.conv.weight")
# must not match.
_SKIP_RE = re.compile(r"\.(cv2|cv3)\.\d+\.|\.dfl\.")


class _Stub:
    """Placeholder instance for any class the unpickler cannot import."""

    def __init__(self, *args, **kwargs):  # swallow REDUCE args
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self.__dict__["_stub_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (_Stub,), {"__module__": module})


def load_torch_object(path: str) -> Any:
    """torch.load with the tolerant unpickler (CPU map, the full graph)."""
    shim = types.ModuleType("mf_tolerant_pickle")
    shim.Unpickler = _TolerantUnpickler
    shim.load = lambda f, **kw: _TolerantUnpickler(f, **kw).load()
    shim.loads = lambda b, **kw: _TolerantUnpickler(io.BytesIO(b), **kw).load()
    shim.dump = pickle.dump
    shim.dumps = pickle.dumps
    return torch.load(path, map_location="cpu", pickle_module=shim, weights_only=False)


def _walk_module(obj: Any, prefix: str = "") -> dict:
    """Rebuild a state dict from a pickled nn.Module graph (real or stub)."""
    out: dict = {}
    d = getattr(obj, "__dict__", None)
    if d is None:
        return out
    for slot in ("_parameters", "_buffers"):
        for name, t in (d.get(slot) or {}).items():
            if t is not None and hasattr(t, "shape"):
                out[prefix + name] = t
    for name, sub in (d.get("_modules") or {}).items():
        if sub is not None:
            out.update(_walk_module(sub, prefix + name + "."))
    return out


def load_ultralytics_state_dict(path: str) -> dict:
    """→ flat {torch_key: tensor} with keys like "model.0.conv.weight"."""
    obj = load_torch_object(path)
    if isinstance(obj, Mapping):
        for key in ("model", "ema"):
            cand = obj.get(key)
            if cand is not None:
                obj = cand
                break
    if isinstance(obj, Mapping):  # already a plain state dict
        return {k: v for k, v in obj.items() if hasattr(v, "shape")}
    sd = _walk_module(obj)
    if not sd:
        raise ValueError(f"no tensors found in {path!r}")
    return sd


def convert_yolo(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """ultralytics YOLOv10 state dict → the port's YoloV10 state dict: the
    one-to-one branch and the trunk, floating tensors as float32, and a
    zero ``num_batches_tracked`` for a BatchNorm that lacks one."""
    sd: dict[str, torch.Tensor] = {}
    for key, t in state_dict.items():
        if _SKIP_RE.search(f".{key}"):
            continue
        t = torch.as_tensor(t).detach().cpu()
        sd[key] = t.float() if t.is_floating_point() else t
    for key in list(sd):
        if key.endswith(".bn.running_mean"):
            sd.setdefault(key[:-len("running_mean")] + "num_batches_tracked",
                          torch.zeros((), dtype=torch.int64))
    return sd


def check_yolo_state(state: Mapping[str, Any], model: torch.nn.Module) -> None:
    """Raise ValueError naming every key ``state`` has that ``model`` lacks,
    every key it lacks, and every shape that differs."""
    want = model.state_dict()
    extra = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    shapes = sorted(f"{k} {tuple(state[k].shape)} != {tuple(want[k].shape)}"
                    for k in set(state) & set(want)
                    if tuple(state[k].shape) != tuple(want[k].shape))
    if extra or missing or shapes:
        raise ValueError(
            f"YOLO checkpoint does not fit the model: unmapped keys {extra[:8]}, "
            f"missing keys {missing[:8]}, shapes {shapes[:8]} — the layer spec in "
            "models/yolo.py likely disagrees with this checkpoint's block layout "
            "(or its scale / class count)")


def convert_yolo_file(path: str) -> dict[str, torch.Tensor]:
    return convert_yolo(load_ultralytics_state_dict(path))
