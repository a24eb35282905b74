"""Flat checkpoints with a manifest and an async save (port of
``repro.checkpointing.checkpoint``; paper §2.4.2/§3.2).

Layout (one directory per step), byte-compatible with the reference:

    step_000123/
      manifest.json            # keys, shapes, dtypes, meta, save_nonce
      arrays/<flat-key>.npy    # one file per leaf

Trees are the port's nested dicts of tensors. Leaves are flattened in the
JAX package's order
(dict keys sorted) under its path keys joined by ``"::"``: any other
order or key would change every manifest and every chunk id of the
chunk store. bf16 leaves are stored as their raw ``uint16`` bits under
the dtype name ``"bfloat16"``, as the reference writes them, and come
back through ``Tensor.view(torch.bfloat16)``; no ``ml_dtypes`` is
needed. numpy leaves are accepted wherever tensors are (an ``ml_dtypes``
bf16 array is read through its ``uint16`` view). Restores return CPU
tensors.

Writes are atomic (tmp dir + rename), so a crash mid-save never
corrupts the latest checkpoint.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

_SEP = "::"

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype (numpy's names; bf16 is
    ``"bfloat16"``)."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


def resolve_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown checkpoint dtype {name!r}") from None


def as_tensor(x) -> torch.Tensor:
    """A tree leaf as a tensor: tensors as they are, numpy arrays and
    scalars through numpy (an ``ml_dtypes`` bf16 array through its raw
    bits)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if str(arr.dtype) == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16).copy()
        ).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def host_array(x) -> tuple[np.ndarray, str]:
    """(C-order numpy array of the leaf's bytes on the host, dtype name).
    bf16 comes back as its ``uint16`` bits."""
    t = as_tensor(x).detach()
    name = dtype_name(t.dtype)
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def leaf_to_bytes(x) -> tuple[bytes, str]:
    """C-order raw bytes + dtype name."""
    arr, name = host_array(x)
    return arr.tobytes(), name


def leaf_from_bytes(buf, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor of ``dtype`` (a manifest name) and ``shape`` from raw
    bytes: a view of a writable buffer (``bytearray``), else a copy."""
    dt = resolve_dtype(dtype)
    arr = np.frombuffer(buf, np.int16 if dt == torch.bfloat16
                        else np.dtype(dtype))
    if not arr.flags.writeable:
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.reshape(tuple(shape))


def _walk(tree, prefix=()):
    """(key path, leaf) pairs, dict keys in sorted order (JAX's)."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _walk(tree[k], prefix + (k,))


def _flatten(tree: Any) -> dict[str, Any]:
    """Flat ``path-key -> leaf`` dict (leaves as they are), in the JAX
    package's order."""
    return {_SEP.join(str(k) for k in path): leaf
            for path, leaf in _walk(tree)}


def unflatten_like(like: Any, out_flat: dict[str, Any]) -> Any:
    """Rebuild ``like``'s structure from a flat key->leaf dict (the
    inverse of ``_flatten``; shared by every restore path)."""
    def build(node, prefix):
        if not isinstance(node, dict):
            return out_flat[_SEP.join(str(k) for k in prefix)]
        return {k: build(v, prefix + (k,)) for k, v in node.items()}
    return build(like, ())


def structure(tree: Any) -> str:
    """A readable structure string (the manifest's ``treedef``, which
    ``restore`` never reads)."""
    if not isinstance(tree, dict):
        return "*"
    return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                           for k in sorted(tree)) + "}"


def save(ckpt_dir: str | pathlib.Path, step: int, tree: Any,
         extra_meta: dict | None = None) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    # per-save nonce: two saves of the same step are never byte-identical,
    # so the server's consistency re-read can detect a same-step
    # replacement mid-serve
    manifest = {"step": step, "keys": {}, "meta": extra_meta or {},
                "save_nonce": os.urandom(8).hex(),
                "treedef": structure(tree)}
    for key, leaf in _flatten(tree).items():
        fname = key.replace("/", "_") + ".npy"
        arr, dtype = host_array(leaf)
        raw = dtype == "bfloat16"     # stored as its uint16 bits
        np.save(tmp / "arrays" / fname, arr)
        manifest["keys"][key] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": dtype, "raw_bits": raw}
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        # swap via rename: a concurrent CheckpointServer read sees either
        # the old or the new dir
        doomed = ckpt_dir / f".old_step_{step:08d}"
        if doomed.exists():
            shutil.rmtree(doomed)
        final.rename(doomed)
        tmp.rename(final)
        shutil.rmtree(doomed)
    else:
        tmp.rename(final)
    return final


def save_async(ckpt_dir, step, tree, extra_meta=None) -> threading.Thread:
    """Non-blocking save: copy to the host, then write on a background
    thread while training continues."""
    host_tree = unflatten_like(tree, {
        k: as_tensor(v).detach().to("cpu", copy=True)
        for k, v in _flatten(tree).items()})
    t = threading.Thread(target=save,
                         args=(ckpt_dir, step, host_tree, extra_meta),
                         daemon=True)
    t.start()
    return t


def restore(ckpt_dir: str | pathlib.Path, like: Any,
            step: int | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (CPU tensors of the stored
    dtypes)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out_flat = {}
    for key in _flatten(like):
        info = manifest["keys"][key]
        arr = np.load(d / "arrays" / info["file"])
        out_flat[key] = leaf_from_bytes(arr.tobytes(), info["dtype"],
                                        info["shape"])
    return unflatten_like(like, out_flat), manifest["meta"]


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_")]
    return max(steps) if steps else None
