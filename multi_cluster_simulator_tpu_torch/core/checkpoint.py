"""Checkpoint / resume for simulation state (the port of
``multi_cluster_simulator_tpu/core/checkpoint.py``, name for name).

The whole constellation is one ``SimState`` of tensors (core/state.py), so
a checkpoint is one serialization and resume is bit-exact: the clock, every
queue, the running set, the arrival cursors, the drop counters, the fault
plane's churn clocks and the trader's snapshots all round-trip.

The file is the reference's ``MCSCKPT1`` format (version 2), byte for
byte: the magic, a ``<I`` header length, a JSON header, then the state-dict
as flax's ``to_bytes`` writes it — nested maps of the dataclasses' fields in
declaration order (a plain dict's keys sorted, as ``jax.tree.map`` leaves
them), every leaf a msgpack ext-1 numpy array (``utils/msgpack.py``, which
needs neither flax nor msgpack). A checkpoint either package writes loads
in the other.

The header is load-bearing, not advisory: besides the virtual clock and
the caller's ``extra`` dict it embeds the format version and, where the
writer supplies them, the full ``SimConfig`` description, the compact
storage plan and the policy-params digest; ``load_state`` refuses a
mismatch with a message naming the differing field. Loading needs a
template state built from the same config and specs (shapes are derived
from the config, not stored); the loaded leaves land on the template's
device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct as _struct
from typing import Optional

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.utils import msgpack

_MAGIC = b"MCSCKPT1"
# bumped whenever the header contract changes; v1 (the pre-digest format
# whose header was advisory) is refused
FORMAT_VERSION = 2

# "the caller did not supply a plan to check", as distinct from "the caller
# asserts the wide layout" (plan None)
_UNSET = object()


# --------------------------------------------------------------------------
# digests: canonical descriptions of what a checkpoint is only valid for
# --------------------------------------------------------------------------

def _canon_json(obj) -> str:
    """Canonical JSON for digesting and diffing (every config enum is a
    str subclass; keys sort)."""
    return json.dumps(obj, sort_keys=True)


# Execution-strategy fields, which cannot change results: left out of the
# description, so a run may be checkpointed by one package or path and
# resumed by another.
_STRATEGY_FIELDS = ("fused", "fused_block", "fused_interpret")


def config_describe(cfg) -> dict:
    """The nested ``SimConfig`` as JSON-able data, without the strategy
    fields: stored in the header so a mismatch can name the field."""
    d = dataclasses.asdict(cfg)
    for f in _STRATEGY_FIELDS:
        d.pop(f, None)
    return d


def digest_of(obj) -> str:
    """sha1[:12] of the canonical JSON form: the one digest recipe."""
    return hashlib.sha1(_canon_json(obj).encode()).hexdigest()[:12]


def config_digest(cfg) -> str:
    return digest_of(config_describe(cfg))


def plan_describe(plan) -> Optional[dict]:
    """The compact storage plan (core/compact.CompactPlan) as JSON-able
    data; ``None`` is the wide layout, itself a checkable value."""
    if plan is None:
        return None
    return {"queue": list(map(list, plan.queue)),
            "run": list(map(list, plan.run)), "node": plan.node}


def plan_digest(plan) -> str:
    return digest_of(plan_describe(plan))


def _dict_diff(want: dict, got: dict, prefix="") -> list:
    """Dotted paths where two nested descriptions differ."""
    out = []
    for k in sorted(set(want) | set(got)):
        w, g = want.get(k, "<absent>"), got.get(k, "<absent>")
        if isinstance(w, dict) and isinstance(g, dict):
            out.extend(_dict_diff(w, g, prefix=f"{prefix}{k}."))
        elif w != g:
            out.append(f"{prefix}{k} (checkpoint: {g!r}, expected: {w!r})")
    return out


def _check_header(header: dict, path: str, cfg=None, plan=_UNSET,
                  policy_digest: Optional[str] = None) -> None:
    v = header.get("v", 1)
    if v != FORMAT_VERSION:
        raise ValueError(
            f"{path}: checkpoint format v{v}; this build reads "
            f"v{FORMAT_VERSION} — re-create the checkpoint")
    if cfg is not None:
        if "config" not in header:
            raise ValueError(
                f"{path}: checkpoint carries no SimConfig record; cannot "
                "verify it matches the resuming config — re-create it with "
                "save_state(..., cfg=...)")
        # the header came through JSON (tuples are lists there): compare
        # both sides in that form
        want = json.loads(_canon_json(config_describe(cfg)))
        diffs = _dict_diff(want, header["config"])
        if diffs:
            raise ValueError(
                f"{path}: checkpoint was written under a different "
                f"SimConfig — differing field(s): " + "; ".join(diffs[:8]))
    if plan is not _UNSET:
        if "plan" not in header:
            raise ValueError(
                f"{path}: checkpoint carries no compact-plan record; "
                "cannot verify the storage layout — re-create it with "
                "save_state(..., plan=...)")
        want, got = plan_describe(plan), header["plan"]
        if want != got:
            if (want is None) != (got is None):
                detail = (f"checkpoint layout: "
                          f"{'wide' if got is None else 'compact'}, "
                          f"expected: {'wide' if want is None else 'compact'}")
            else:
                diffs = _dict_diff(want, got)
                detail = "differing field(s): " + "; ".join(diffs[:8])
            raise ValueError(
                f"{path}: checkpoint was written under a different compact "
                f"storage plan — {detail}")
    if policy_digest is not None:
        got = header.get("policy_digest")
        if got != policy_digest:
            raise ValueError(
                f"{path}: checkpoint was written under different policy "
                f"params (digest {got!r}, expected {policy_digest!r})")


# --------------------------------------------------------------------------
# the state-dict: the port's dataclasses as flax's to_state_dict walks them
# --------------------------------------------------------------------------

def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_state_dict(tree):
    """``tree`` (a dataclass of tensors, a dict of them, or their host
    numpy twins) as the reference's payload holds it: a dataclass's fields
    in declaration order, a dict's keys sorted, every leaf a host array."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_state_dict(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {str(k): to_state_dict(tree[k]) for k in sorted(tree)}
    return _to_host(tree)


def _restore(template, sd, path: str):
    """``template``'s structure with the leaves of ``sd`` (flax's
    ``from_state_dict``: a missing or an unknown field raises), as host
    arrays; returns ``(tree, [(template leaf, array), ...])``."""
    if dataclasses.is_dataclass(template) or isinstance(template, dict):
        if not isinstance(sd, dict):
            raise ValueError(f"checkpoint: {path or '.'} is not a map")
        names = ([f.name for f in dataclasses.fields(template)]
                 if dataclasses.is_dataclass(template)
                 else [str(k) for k in template])
        missing = [n for n in names if n not in sd]
        if missing:
            raise ValueError(f"Missing field {missing[0]} in state dict "
                             f"while restoring an instance of "
                             f"{type(template).__name__}, at path "
                             f"{path or '.'}")
        extra = sorted(set(sd) - set(names))
        if extra:
            raise ValueError(f'Unknown field(s) "{",".join(extra)}" in state '
                             f"dict while restoring an instance of "
                             f"{type(template).__name__} at path "
                             f"{path or '.'}")
        pairs, kw = [], {}
        for n in names:
            sub = getattr(template, n) if dataclasses.is_dataclass(
                template) else template[n]
            kw[n], p = _restore(sub, sd[n], f"{path}/{n}")
            pairs += p
        if isinstance(template, dict):
            return kw, pairs
        return dataclasses.replace(template, **kw), pairs
    return sd, [(template, sd)]


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a tensor dtype (``torch.uint32`` -> uint32)."""
    return np.dtype(str(dtype).removeprefix("torch."))


def _leaf_spec(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), np_dtype(x.dtype)
    return np.shape(x), np.asarray(x).dtype


def _to_device(tree, like):
    """The restored host tree as tensors on each template leaf's device."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _to_device(getattr(tree, f.name), getattr(like, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _to_device(v, like[k]) for k, v in tree.items()}
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.from_numpy(np.asarray(tree)).to(dev)


# --------------------------------------------------------------------------
# low-level framed I/O (shared by state checkpoints and run bundles)
# --------------------------------------------------------------------------

def _write(path: str, header: dict, payload: bytes) -> None:
    """Atomic framed write: magic, header length, JSON header, payload —
    to ``path + '.tmp'``, fsynced, then ``os.replace``, so a kill at any
    byte of the write leaves an existing checkpoint whole."""
    hdr = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(_struct.pack("<I", len(hdr)))
        f.write(hdr)
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read(path: str) -> tuple[dict, bytes]:
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a simulator checkpoint")
        (hlen,) = _struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        payload = f.read()
    return header, payload


def save_tree(tree, path: str, t: int, extra: Optional[dict] = None,
              cfg=None, plan=_UNSET,
              policy_digest: Optional[str] = None) -> None:
    """Write a checkpoint of any tree of dataclasses and dicts (the core
    of ``save_state`` and the run bundles). ``t`` is the virtual clock
    ``peek_checkpoint_t`` reads; ``cfg``/``plan``/``policy_digest`` embed
    the validity record the loader verifies."""
    sd = to_state_dict(tree)  # device -> host once
    header = {"v": FORMAT_VERSION, "t": int(t), "extra": extra or {}}
    if cfg is not None:
        header["config"] = config_describe(cfg)
        header["config_digest"] = config_digest(cfg)
    if plan is not _UNSET:
        header["plan"] = plan_describe(plan)
        header["plan_digest"] = plan_digest(plan)
    if policy_digest is not None:
        header["policy_digest"] = policy_digest
    _write(path, header, msgpack.packb(sd))


def load_tree(path: str, template, cfg=None, plan=_UNSET,
              policy_digest: Optional[str] = None):
    """Restore a checkpoint into the structure of ``template``. The header
    is verified first (version, then config, plan and policy where the
    caller supplies them: a named field beats a shape error), then every
    leaf's shape and dtype against the template's. The leaves land on the
    template leaves' devices."""
    header, payload = _read(path)
    _check_header(header, path, cfg=cfg, plan=plan,
                  policy_digest=policy_digest)
    restored, pairs = _restore(template, msgpack.unpackb(payload), "")
    for a, b in pairs:
        (sa, da), (sb, db) = _leaf_spec(a), _leaf_spec(b)
        if sa != sb or da != db:
            raise ValueError(
                f"checkpoint leaf mismatch: {sb}/{db} vs {sa}/{da} "
                "— was it written under a different SimConfig?")
    return _to_device(restored, template)


# --------------------------------------------------------------------------
# the SimState checkpoint surface
# --------------------------------------------------------------------------

def save_state(state: SimState, path: str, extra: Optional[dict] = None,
               cfg=None, plan=_UNSET,
               policy_digest: Optional[str] = None) -> None:
    """Write a SimState checkpoint, atomically (``_write``). ``extra`` is a
    JSON-able dict stored in the header (host state the tensors cannot
    carry); ``cfg``/``plan``/``policy_digest`` embed the validity record
    ``load_state`` verifies."""
    save_tree(state, path, t=int(_to_host(state.t)), extra=extra, cfg=cfg,
              plan=plan, policy_digest=policy_digest)


def load_state(path: str, template: SimState, cfg=None, plan=_UNSET,
               policy_digest: Optional[str] = None) -> SimState:
    """Restore a checkpoint into the shapes of ``template`` (normally
    ``init_state(cfg, specs)`` for the same config), on its device.
    Version, digest, shape and dtype mismatches all raise."""
    return load_tree(path, template, cfg=cfg, plan=plan,
                     policy_digest=policy_digest)


def _read_header(path: str) -> dict:
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a simulator checkpoint")
        (hlen,) = _struct.unpack("<I", f.read(4))
        return json.loads(f.read(hlen))


def peek_checkpoint_t(path: str) -> int:
    """The checkpoint's virtual time (ms) without reading the state."""
    return int(_read_header(path)["t"])


def load_extra(path: str) -> dict:
    """The host-side ``extra`` dict stored beside the state."""
    return _read_header(path).get("extra") or {}
