"""Keras ``.h5`` weight files → the face-attribute nets' state dicts.

Port of mere_fusion_tpu/utils/keras_convert.py. DeepFace distributes its
attribute models as Keras weight files (age_model_weights.h5,
gender_model_weights.h5, race_model_single_batch.h5,
facial_expression_model_weights.h5; consumed by the reference through
``DeepFace.analyze``, yolo_opencv.py:202-217). Their layer names are
generated and vary across saves, so conversion is by order: the weighted
layers are read in the file's recorded layer order and assigned to the
module's slots in definition order, with loud shape checks.

Keras stores conv kernels (kh, kw, cin, cout) and dense kernels (in, out);
they become torch's (cout, cin, kh, kw) and (out, in). ``EmotionNet``
flattens channels-last as Keras does, so dense rows keep their order.
``h5py`` is imported when a file is read.
"""
from __future__ import annotations

import numpy as np
import torch


def _decode(name) -> str:
    return name.decode() if isinstance(name, bytes) else str(name)


def h5_weight_arrays(path: str) -> list[tuple[str, list[np.ndarray]]]:
    """(layer_name, [arrays...]) for every weighted layer, in the file's
    layer order; weights-only files and full model saves (which nest
    everything under ``model_weights``) both read. Needs ``h5py``: an
    ImportError names it when it is absent."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"reading the Keras weights {path!r} needs the h5py package, which is not "
            "installed here: convert them on a host that has h5py with python -m "
            "mere_fusion_tpu_torch.tools.convert_ckpt face-<task> <file.h5> <out_dir>, "
            "and serve out_dir") from e

    out = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        for ln in [_decode(n) for n in root.attrs["layer_names"]]:
            group = root[ln]
            names = [_decode(n) for n in group.attrs.get("weight_names", [])]
            arrays = [np.asarray(group[wn], dtype=np.float32) for wn in names]
            if arrays:
                out.append((ln, arrays))
    return out


def _assign(pairs, slots, what: str) -> dict[str, torch.Tensor]:
    """Zip ordered (kernel, bias) layer weights onto named module slots,
    each slot's Keras kernel shape checked."""
    if len(pairs) != len(slots):
        raise ValueError(
            f"{what}: file has {len(pairs)} weighted layers "
            f"({[n for n, _ in pairs]}), model expects {len(slots)} "
            f"({[s for s, _ in slots]})")
    sd = {}
    for (layer_name, arrays), (slot, kernel_shape) in zip(pairs, slots):
        if len(arrays) != 2:
            raise ValueError(
                f"{what}: layer {layer_name!r} has {len(arrays)} arrays, "
                f"expected kernel+bias for slot {slot!r}")
        kernel, bias = arrays
        if tuple(kernel.shape) != tuple(kernel_shape):
            raise ValueError(
                f"{what}: layer {layer_name!r} kernel {kernel.shape} does "
                f"not match slot {slot!r} {kernel_shape}")
        kernel = kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T
        sd[f"{slot}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        sd[f"{slot}.bias"] = torch.from_numpy(np.ascontiguousarray(bias))
    return sd


def vggface_slots(n_classes: int, width: float = 1.0) -> list[tuple[str, tuple]]:
    """(slot, Keras kernel shape) of VGGFaceAttr, in order."""
    from mere_fusion_tpu_torch.models.face_attrs import _VGG_BLOCKS, _width

    c = _width(width)
    slots, cin, i = [], 3, 0
    for channels, reps in _VGG_BLOCKS:
        for _ in range(reps):
            slots.append((f"conv_{i}", (3, 3, cin, c(channels))))
            cin, i = c(channels), i + 1
    slots.append(("fc_0", (7, 7, cin, c(4096))))
    slots.append(("fc_1", (1, 1, c(4096), c(4096))))
    slots.append(("head", (1, 1, c(4096), n_classes)))
    return slots


def emotion_slots(width: float = 1.0) -> list[tuple[str, tuple]]:
    """(slot, Keras kernel shape) of EmotionNet, in order."""
    from mere_fusion_tpu_torch.models.face_attrs import _width

    c = _width(width)
    return [("conv_0", (5, 5, 1, c(64))), ("conv_1", (3, 3, c(64), c(64))),
            ("conv_2", (3, 3, c(64), c(64))), ("conv_3", (3, 3, c(64), c(128))),
            ("conv_4", (3, 3, c(128), c(128))), ("dense_0", (c(128), c(1024))),
            ("dense_1", (c(1024), c(1024))), ("dense_2", (c(1024), 7))]


def convert_vggface_h5(path: str, n_classes: int, width: float = 1.0) -> dict[str, torch.Tensor]:
    """age/gender/race weight file → VGGFaceAttr state dict."""
    return _assign(h5_weight_arrays(path), vggface_slots(n_classes, width),
                   f"VGGFaceAttr(n_classes={n_classes})")


def convert_emotion_h5(path: str, width: float = 1.0) -> dict[str, torch.Tensor]:
    """facial_expression_model_weights.h5 → EmotionNet state dict."""
    return _assign(h5_weight_arrays(path), emotion_slots(width), "EmotionNet")
