"""Tree checkpointing: flat-path npz arrays + a JSON manifest.

The on-disk format is the reference's (``repro/ckpt/store.py``), so a
checkpoint written by either package restores into the other: the npz
holds one array per "a/b/c" leaf path in the reference's layout (conv
kernels channels-last, converted with ``convert.py`` on the way in and
out), and the manifest holds the paths, shapes, dtypes, a CRC32 of the
npz, ``FORMAT_VERSION`` and the run's metadata (round, history,
selection history).

Writes are crash-atomic: both files are staged to a tmp path, fsync'd
and ``os.replace``'d, the npz committed *before* the manifest, so a kill
at any byte leaves either the previous complete checkpoint or the new
one.  Restores verify the CRC32 and the format version and raise typed
errors (:class:`CorruptCheckpointError`, :class:`CheckpointVersionError`).

Server state covers the synchronous engine: params (the topology state:
gossip's client-stacked replicas), history, ``sel_history``, the scored
``SelectionState`` and a stateful codec's error-feedback residual.  The
reference's round key (threefry words) has no torch twin, so the port
never writes ``key``: it writes its CPU generator's state, and a
stochastic codec's device generator's state, under fields of their own
(``torch_generator``, ``torch_codec_generator``).  A restore without them
keeps the generators the caller seeded, as the reference's restore keeps
its caller's key when a file has no ``key``.
"""
from __future__ import annotations

import base64
import io
import json
import os
import zipfile
import zlib
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..common import flatten, sorted_tree
from ..convert import from_reference, reference_shape, to_reference_flat

# bump when the on-disk layout changes incompatibly; readers accept
# anything <= their own version (manifests without one are version 0)
FORMAT_VERSION = 1

# reference manifest fields of engines the port does not have yet
_UNPORTED_STATE = {
    "async": "the buffered-async engine (FLConfig.async_buffer)",
    "cohort": "the cohort engine (FLConfig.n_registered/cohort_chunk)",
    "sel_base": "history_cap retention (FLConfig.history_cap)",
}


class CheckpointError(RuntimeError):
    """Base class for typed checkpoint-restore failures."""


class CorruptCheckpointError(CheckpointError):
    """The checkpoint bytes are damaged (truncated, bit-flipped, or not
    the format the manifest promises)."""


class CheckpointVersionError(CheckpointError):
    """The checkpoint was written by a newer format than this reader."""


class _Spec(NamedTuple):
    """Shape and dtype of a leaf a restore expects."""
    shape: tuple
    dtype: Any


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".json"


def _atomic_write(path: str, data: bytes) -> None:
    """tmp file + fsync + rename: the previous complete file survives a
    crash at any point, and readers never observe a partial write."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree: Mapping[str, Any],
                metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (nested or "a/b"-flat dicts of tensors or arrays)
    and ``metadata`` (JSON-serializable) as a checkpoint at ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _numpy(v) for k, v in sorted_tree(flatten(tree)).items()}
    buf = io.BytesIO()
    np.savez(buf, **flat)
    payload = buf.getvalue()
    manifest = {
        "format_version": FORMAT_VERSION,
        "checksum": zlib.crc32(payload) & 0xFFFFFFFF,
        "paths": list(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "metadata": metadata or {},
    }
    # npz first, manifest second: the manifest (whose checksum covers the
    # npz) is the commit point
    _atomic_write(_npz_path(path), payload)
    _atomic_write(_manifest_path(path),
                  json.dumps(manifest, indent=1).encode())


def _read_manifest(path: str) -> Dict:
    mp = _manifest_path(path)
    if not os.path.exists(mp):
        return {}
    try:
        with open(mp) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptCheckpointError(
            f"checkpoint manifest {mp} is not valid JSON ({e}); the "
            "write was torn or the file was damaged") from None
    ver = int(manifest.get("format_version", 0))
    if ver > FORMAT_VERSION:
        raise CheckpointVersionError(
            f"checkpoint {path} is format version {ver}, this reader "
            f"understands <= {FORMAT_VERSION}; upgrade the code or "
            "re-save the checkpoint")
    return manifest


def _verified_bytes(path: str, manifest: Dict) -> bytes:
    npz_path = _npz_path(path)
    try:
        with open(npz_path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise CorruptCheckpointError(
            f"checkpoint arrays {npz_path} unreadable: {e}") from None
    want = manifest.get("checksum")
    if want is not None and (zlib.crc32(data) & 0xFFFFFFFF) != int(want):
        raise CorruptCheckpointError(
            f"checkpoint {npz_path} fails its CRC32 check: the file is "
            "truncated or bit-flipped; restore from the previous "
            "checkpoint")
    return data


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def load_pytree(path: str, like: Mapping[str, Any]) -> Dict[str, Any]:
    """Restore into the structure of ``like``: a (nested or "a/b"-flat)
    dict whose leaves have a ``shape`` and a ``dtype`` (tensors, arrays).
    Returns tensors of ``like``'s dtypes, on a tensor leaf's device
    (the CPU otherwise)."""
    manifest = _read_manifest(path)
    data = _verified_bytes(path, manifest)
    try:
        npz = np.load(io.BytesIO(data))
        flat = {k: npz[k] for k in npz.files}
    except (zipfile.BadZipFile, ValueError, OSError, EOFError,
            KeyError) as e:
        raise CorruptCheckpointError(
            f"checkpoint {_npz_path(path)} is not a readable npz "
            f"archive ({e}); the file is truncated or damaged") from None

    def fill(p, leaf):
        if p not in flat:
            raise CorruptCheckpointError(
                f"checkpoint {_npz_path(path)} is missing array {p!r} "
                "the restore template requires")
        arr = flat[p]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{p}: checkpoint shape {arr.shape} != "
                             f"template {tuple(leaf.shape)}")
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=_torch_dtype(leaf.dtype))

    def walk(node, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, Mapping)
                else fill(f"{prefix}{k}", v) for k, v in node.items()}

    return walk(like, "")


def load_metadata(path: str) -> Dict:
    if not os.path.exists(_manifest_path(path)):
        raise FileNotFoundError(_manifest_path(path))
    return _read_manifest(path).get("metadata", {})


def _b64_state(gen: torch.Generator) -> str:
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode()


def _set_b64_state(gen: torch.Generator, text: str) -> None:
    raw = np.frombuffer(base64.b64decode(text), np.uint8).copy()
    gen.set_state(torch.from_numpy(raw))


def save_server_state(path: str, server, extra: Optional[Dict] = None,
                      pending_record: Optional[Any] = None) -> None:
    """``pending_record`` lets a Checkpointer hook persist the round it
    is being called for: end-of-round hooks run before the server
    appends the record to ``history``."""
    history = list(server.history)
    if pending_record is not None:
        history.append(pending_record)
    meta = {
        "round": len(history),
        "history": [vars(r) for r in history],
        "sel_history": [np.asarray(s).tolist() for s in server.sel_history],
        "torch_generator": _b64_state(server.generator),
    }
    if server.codec_generator is not None:
        meta["torch_codec_generator"] = _b64_state(server.codec_generator)
    meta.update(extra or {})
    cs = server.conv_spatial
    tree = to_reference_flat(server.params, conv_spatial=cs)
    wrapped = False
    if server.codec_state is not None:
        # the per-client error-feedback residuals are part of the run's
        # trajectory: a resume without them would drop folded-back error
        tree = {"params": tree,
                "codec_state": to_reference_flat(server.codec_state,
                                                 conv_spatial=cs)}
        wrapped = True
        meta["codec_state"] = True
    if server.sel_state is not None:
        if not wrapped:
            tree = {"params": tree}
        tree["sel_state"] = {k: _numpy(v) for k, v in
                             server.sel_state._asdict().items()}
        meta["sel_state"] = True
    save_pytree(path, tree, metadata=meta)


def _ref_spec(tree, conv_spatial: int) -> Dict[str, _Spec]:
    """Reference-layout shapes of a port tree (no copies)."""
    return {p: _Spec(reference_shape(p, x.shape, conv_spatial=conv_spatial),
                     x.dtype) for p, x in tree.items()}


def _to_port(loaded, like, conv_spatial: int):
    """Reference-layout tensors -> the port's layout, on ``like``'s
    devices and dtypes."""
    port = from_reference({p: x.numpy() for p, x in loaded.items()},
                          conv_spatial=conv_spatial)
    return {p: port[p].to(device=x.device, dtype=x.dtype)
            for p, x in like.items()}


def restore_server_state(path: str, server) -> Dict:
    """Restore params (= topology state), history, selection history,
    the scored selection state, a stateful codec's residual and the
    generators, so a resumed ``fit`` continues bitwise."""
    meta = load_metadata(path)
    for field, engine in _UNPORTED_STATE.items():
        if field in meta:
            raise ValueError(
                f"checkpoint holds {field!r} state of {engine}, which "
                "repro_torch has not ported yet; restore it with the "
                "reference package")
    scored = bool(meta.get("sel_state"))
    sel_state = server.sel_state
    if scored and sel_state is None:
        raise ValueError(
            "checkpoint holds scored-selection state; restore it into a "
            "Federation configured with the original stateful strategy")
    if sel_state is not None and not scored:
        raise ValueError(
            "this server's strategy is stateful but the checkpoint has "
            "no selection state; restore with the original strategy")
    codec_saved = bool(meta.get("codec_state"))
    codec_state = server.codec_state
    if codec_saved and codec_state is None:
        raise ValueError(
            "checkpoint holds codec error-feedback state; restore it "
            "into a Federation configured with the original stateful "
            "FLConfig.codec")
    if codec_state is not None and not codec_saved:
        raise ValueError(
            "this server's codec is stateful but the checkpoint has no "
            "codec state; restore with the original FLConfig.codec")
    cs = server.conv_spatial
    template: Dict[str, Any] = _ref_spec(server.params, cs)
    if scored or codec_saved:
        template = {"params": template}
        if scored:
            template["sel_state"] = dict(sel_state._asdict())
        if codec_saved:
            template["codec_state"] = _ref_spec(codec_state, cs)
    tree = load_pytree(path, template)
    params = tree["params"] if (scored or codec_saved) else tree
    server.params = _to_port(params, server.params, cs)
    if codec_saved:
        server.codec_state = _to_port(tree["codec_state"], codec_state, cs)
    if scored:
        server.sel_state = type(sel_state)(**tree["sel_state"])
    if "history" in meta:
        from ..core.server import RoundRecord
        server.history = [RoundRecord(**r) for r in meta["history"]]
    if "sel_history" in meta:
        server.sel_history = [np.asarray(s, np.float32)
                              for s in meta["sel_history"]]
    if "torch_generator" in meta:
        _set_b64_state(server.generator, meta["torch_generator"])
    if "torch_codec_generator" in meta and \
            server.codec_generator is not None:
        _set_b64_state(server.codec_generator, meta["torch_codec_generator"])
    return meta
