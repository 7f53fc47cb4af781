"""Checkpoint save/load: params + optimizer state + loop position + metrics
(the port of dlrm_tpu/train/checkpoint.py, single-process).

The files are the JAX package's, so a checkpoint written by either package
loads in the other: `arrays.npz` holds every leaf under its path key
("params/emb/stacked", "params/bot/0/w", "opt/accum/...", "opt/step"; the
optimizer step as a 0-d int32), `meta.json` the caller's meta and the save
id. Every file carries the save id and meta.json is written last, so a
directory that mixes two saves (a crash mid-save) refuses to load; a
checkpoint from before save ids loads without the check. A per-shard
checkpoint (`shard_*.npz` + `sharding.json`, written by the JAX package's
sharded runs) loads by concatenating each array's blocks on its sharded
axis. An unsharded save retires a stale `sharding.json` in its directory.

Reference: the torch.save/load checkpointing of dlrm_s_pytorch.py:1398-1456
(load with fast-forward) and :1702-1715 (save-on-best).
"""

from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dlrm_tpu_torch.device import process_count

SAVE_ID_KEY = "__save_id__"


def flatten_with_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path key: leaf} in the JAX package's tree order: dict keys sorted,
    list items in order, keys joined with "/"."""
    out: Dict[str, Any] = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + (str(k),))
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = x

    walk(tree, (prefix,) if prefix else ())
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):  # the optimizer step, kept on the host
        return np.asarray(leaf, dtype=np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _like(leaf, arr: np.ndarray):
    """`arr` as the template leaf's kind: a Python int for an int leaf, else
    a tensor on the leaf's device."""
    if isinstance(leaf, int):
        return int(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(leaf.device)


def _unflatten_like(template, flat: Dict[str, Any], prefix: str):
    def build(x, path):
        if isinstance(x, dict):
            return {k: build(v, path + (str(k),)) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(build(v, path + (str(i),)) for i, v in enumerate(x))
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = flat[key]
        want = () if isinstance(x, int) else tuple(x.shape)
        if tuple(np.shape(arr)) != want:
            raise ValueError(
                f"checkpoint array {key!r} has shape {np.shape(arr)}, "
                f"expected {want}"
            )
        return _like(x, arr)

    return build(template, (prefix,))


def save_checkpoint(
    path: str,
    params,
    opt_state=None,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    """Write params (and opt_state) as arrays.npz, then meta.json with the
    save id. Each file is written to a temporary name and renamed into
    place."""
    if process_count() > 1:
        raise NotImplementedError(
            "a multi-process checkpoint save is not ported yet (ROADMAP "
            "queue A item 11)"
        )
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v)
              for k, v in flatten_with_paths(params, "params").items()}
    if opt_state is not None:
        arrays.update({k: _to_numpy(v)
                       for k, v in flatten_with_paths(opt_state, "opt").items()})
    save_id = uuid.uuid4().hex
    stamp = np.frombuffer(save_id.encode(), np.uint8)

    def _atomic_json(name: str, obj) -> None:
        tmp = os.path.join(path, f".{name}.tmp")
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)
        os.replace(tmp, os.path.join(path, name))

    tmp = os.path.join(path, ".arrays.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **{SAVE_ID_KEY: stamp}, **arrays)
    os.replace(tmp, os.path.join(path, "arrays.npz"))
    # a manifest left by an earlier sharded save into this directory would
    # make load probe the old shard files and reject this checkpoint
    try:
        os.remove(os.path.join(path, "sharding.json"))
    except FileNotFoundError:
        pass
    _atomic_json("meta.json", {**(meta or {}), "save_id": save_id})


def _check_save_id(z, fname: str, expect_id: Optional[str]) -> None:
    if expect_id is None:
        return  # pre-save-id checkpoint format
    got = (
        bytes(np.asarray(z[SAVE_ID_KEY])).decode()
        if SAVE_ID_KEY in z.files
        else None
    )
    if got != expect_id:
        raise ValueError(
            f"checkpoint is inconsistent: {fname} carries save id {got!r} "
            f"but meta.json committed {expect_id!r} — the directory mixes "
            "files from different saves (interrupted save?); restore from "
            "a complete checkpoint"
        )


def _sharded_arrays(path: str, expect_id: Optional[str]) -> Dict[str, Any]:
    """The arrays of a per-shard checkpoint, each the concatenation of its
    blocks shard_00000.npz, shard_00001.npz, ... on its sharded axis (a
    legacy manifest's bare int means axis 0)."""
    mpath = os.path.join(path, "sharding.json")
    if not os.path.exists(mpath):
        return {}
    with open(mpath) as f:
        manifest = json.load(f)
    blocks: Dict[int, Any] = {}

    def shard(rank):
        if rank not in blocks:
            fname = f"shard_{rank:05d}.npz"
            with np.load(os.path.join(path, fname)) as z:
                _check_save_id(z, fname, expect_id)
                blocks[rank] = {k: z[k] for k in z.files if k != SAVE_ID_KEY}
        return blocks[rank]

    out = {}
    for key, m in manifest.items():
        num, axis = (int(m), 0) if isinstance(m, int) else (int(m[0]),
                                                           int(m[1]))
        out[key] = np.concatenate([shard(r)[key] for r in range(num)],
                                  axis=axis)
    return out


def load_checkpoint(
    path: str,
    params_template,
    opt_state_template=None,
) -> Tuple[Any, Any, Dict[str, Any]]:
    """(params, opt_state, meta): the templates' trees with the checkpoint's
    arrays, each on its template leaf's device (a Python int leaf, the
    optimizer step, stays an int). Raises KeyError for a missing array and
    ValueError for a shape mismatch or a mixed save. opt_state is None when
    no template is given or the checkpoint holds no optimizer state."""
    meta: Dict[str, Any] = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    expect_id = meta.pop("save_id", None)  # internal; not part of caller meta
    with np.load(os.path.join(path, "arrays.npz")) as z:
        _check_save_id(z, "arrays.npz", expect_id)
        flat = {k: z[k] for k in z.files if k != SAVE_ID_KEY}
    flat.update(_sharded_arrays(path, expect_id))
    params = _unflatten_like(params_template, flat, "params")
    opt_state = None
    if opt_state_template is not None and any(
            k.startswith("opt/") for k in flat):
        opt_state = _unflatten_like(opt_state_template, flat, "opt")
    return params, opt_state, meta
