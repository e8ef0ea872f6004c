"""Warm start: ship program-cache keys, rebuild them from the joiner's own
kernel sources (the port's counterpart of the JAX package's
``ctrl/warmstart.py``).

A joining host pays every cold key on its first requests: the kernel
library's build or load, the key's :class:`~tpu_stencil_torch.serve.
engine.BucketProgram` and the arena's pinned slot for its shape. This
module moves that cost ahead of the joiner's ``/healthz``: a warm member
exports the *keys* of its program cache, a joiner pulls the envelope over
``GET /admin/warmstate`` and, for each key, builds the program, takes the
slot and runs one batch of zeros through its own dispatch on its device
(which builds or loads K1 from the sources in its own checkout), then
seeds the program, before its HTTP listener starts. Its first real
request is a program-cache hit.

No binary crosses the wire. The JAX package ships serialized executables;
the port's kernels are shared objects built by ``nvcc`` from
``ops/csrc/``, and a joiner that loaded one received over HTTP would run a
kernel not built from its own sources. The envelope names the exporter's
``torch`` version, platform and kernel-source fingerprint
(:func:`~tpu_stencil_torch.ops._build.fingerprint`) instead, and a joiner
whose own differ degrades.

**Degradation is the contract, not the exception.** Every failure mode
falls back to the cold path, typed per entry in the returned summary and
counted in ``ctrl_warmstart_fallbacks_total``; import never raises on
envelope content and never makes the server wrong (a seeded entry is the
same program the server would build on its first miss). The reasons are
the JAX package's, so one dashboard reads both:

* ``payload_unavailable``: no envelope (the pull failed, or not JSON);
* ``schema_mismatch``: another envelope ``schema_version``;
* ``exporter_unsupported``: the exporter could not ship keys (its kernel
  sources could not be fingerprinted);
* ``version_skew``: another ``torch`` version or kernel fingerprint (a
  JAX package's envelope, which names ``jax`` and no ``torch``, lands
  here too);
* ``platform_skew``: the exporter ran on another platform;
* ``malformed_key``: a key that does not round-trip, names an unknown
  filter, or is not shippable;
* ``deserialize_failed``: the rebuild or the warm run raised (for example
  ``KernelBuildError``).

``no_jax_export`` stays in the vocabulary and is never reported.

Sharded keys are skipped on export, as in the JAX package: their runners
bake in the exporter's mesh. The warm run moves neither
``cache_hits_total`` nor ``cache_misses_total`` and counts no request or
batch, so "first request, zero cache misses" is counter-exact.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

from tpu_stencil_torch.obs import span as _obs_span

#: Envelope schema version; a mismatch degrades the whole payload.
SCHEMA_VERSION = 1

#: Fallback reasons (the typed vocabulary the summary dict reports).
FALLBACK_REASONS = (
    "payload_unavailable",   # pull failed / no payload at all
    "schema_mismatch",       # wrong envelope schema_version
    "exporter_unsupported",  # the warm member could not ship keys
    "no_jax_export",         # the JAX package's reason; never reported
    "version_skew",          # torch version or kernel sources differ
    "platform_skew",         # exporter ran on a different platform
    "malformed_key",         # cache key did not round-trip
    "deserialize_failed",    # the rebuild or the warm run raised
)


def _kernel_fingerprint() -> Optional[str]:
    """The fingerprint of this checkout's kernel sources and flags, or
    None when the sources cannot be read."""
    from tpu_stencil_torch.ops import _build

    try:
        return _build.fingerprint()
    except OSError:
        return None


def _platform(server) -> str:
    return "cuda" if server.device.type == "cuda" else "cpu"


# -- cache-key wire format ---------------------------------------------


def _key_to_wire(key: tuple) -> list:
    """Nested tuples → nested lists (JSON has no tuple)."""
    return [_key_to_wire(k) if isinstance(k, tuple) else k for k in key]


def _key_from_wire(obj: Any) -> tuple:
    if not isinstance(obj, list):
        raise ValueError(f"cache key must be a list, got {type(obj)}")
    return tuple(
        _key_from_wire(k) if isinstance(k, list) else k for k in obj
    )


def _key_geometry(key: tuple) -> Optional[Tuple[int, ...]]:
    """The batch-canvas shape ``(nb, bh, bw[, c])`` of a program keyed
    ``(filter, (bh, bw), channels, dtype, backend, reps, nb)``, or None
    for keys this module does not ship (sharded entries, unknown layouts,
    non-uint8 dtypes)."""
    if len(key) != 7 or "sharded" in key:
        return None
    _fname, bucket, channels, dtype, _backend, _reps, nb = key
    if dtype != "uint8":
        return None
    if (not isinstance(bucket, tuple) or len(bucket) != 2
            or not all(isinstance(v, int) for v in bucket)
            or not isinstance(channels, int) or not isinstance(nb, int)):
        return None
    bh, bw = bucket
    return (nb, bh, bw) + ((channels,) if channels > 1 else ())


def _check_key(key: tuple) -> None:
    """Raise ValueError unless ``key`` is a shippable key this package can
    rebuild: a known filter, positive geometry, 1 or 3 channels, reps >=
    0."""
    from tpu_stencil_torch import filters

    shape = _key_geometry(key)
    if shape is None:
        raise ValueError("unshippable key")
    fname, (bh, bw), channels, _dtype, backend, reps, nb = key
    if not isinstance(fname, str) or not isinstance(backend, str):
        raise ValueError("filter and backend must be names")
    try:
        filters.get_filter(fname)
    except KeyError as e:
        raise ValueError(str(e)) from None
    if (min(bh, bw, nb) < 1 or channels not in (1, 3)
            or not isinstance(reps, int) or reps < 0):
        raise ValueError(f"bad key geometry {key!r}")


# -- export ------------------------------------------------------------


def export_server(server) -> dict:
    """The warm-state envelope of one :class:`~tpu_stencil_torch.serve.
    engine.StencilServer`: the keys of its program cache, with the
    exporter's ``torch`` version, platform and kernel fingerprint. Each
    exported key counts ``ctrl_warmstart_exported_total``."""
    import torch

    exported_c = server.registry.counter("ctrl_warmstart_exported_total")
    envelope: dict = {
        "schema_version": SCHEMA_VERSION,
        "torch": torch.__version__,
        "platform": _platform(server),
        "kernels": _kernel_fingerprint(),
        "entries": [],
    }
    if envelope["kernels"] is None:
        envelope["unsupported"] = ("the kernel sources of this checkout "
                                   "cannot be read, so no joiner can "
                                   "rebuild its kernels")
        return envelope
    with _obs_span("ctrl.warmstart_export", "ctrl"):
        for key in server.warm_keys():
            if _key_geometry(key) is None:
                continue  # sharded / unknown layout: never shipped
            envelope["entries"].append({"key": _key_to_wire(key)})
            exported_c.inc()
    return envelope


# -- import ------------------------------------------------------------


def import_server(server, payload: Optional[dict]) -> dict:
    """Import a warm-state envelope into one server: rebuild and warm-run
    every entry on the server's device, then seed it. Returns
    ``{"imported": n, "fallbacks": n, "reasons": {reason: count}}``;
    every skipped entry (and an unusable payload as a whole) counts one
    typed fallback in ``ctrl_warmstart_fallbacks_total`` and leaves the
    cold path exactly as it was. Never raises on envelope content."""
    import torch

    fallbacks_c = server.registry.counter("ctrl_warmstart_fallbacks_total")
    imported_c = server.registry.counter("ctrl_warmstart_imported_total")
    summary: dict = {"imported": 0, "fallbacks": 0, "reasons": {}}

    def fall(reason: str, n: int = 1) -> None:
        fallbacks_c.inc(n)
        summary["fallbacks"] += n
        summary["reasons"][reason] = summary["reasons"].get(reason, 0) + n

    if not isinstance(payload, dict):
        fall("payload_unavailable")
        return summary
    if payload.get("schema_version") != SCHEMA_VERSION:
        fall("schema_mismatch")
        return summary
    if payload.get("unsupported"):
        fall("exporter_unsupported")
        return summary
    entries = payload.get("entries") or []
    if not entries:
        return summary  # a cold exporter: nothing to degrade FROM
    fingerprint = _kernel_fingerprint()
    if (payload.get("torch") != torch.__version__ or fingerprint is None
            or payload.get("kernels") != fingerprint):
        # Another torch or other kernel sources: the program the exporter
        # ran is not the one this host would build.
        fall("version_skew", len(entries))
        return summary
    if payload.get("platform") != _platform(server):
        fall("platform_skew", len(entries))
        return summary

    with _obs_span("ctrl.warmstart_import", "ctrl",
                   entries=len(entries)):
        for e in entries:
            try:
                key = _key_from_wire(e["key"])
                _check_key(key)
            except Exception:  # noqa: BLE001
                fall("malformed_key")
                continue
            try:
                # Build the program, take its slot and run one batch of
                # zeros on the device now: the kernel library is built or
                # loaded here, before the joiner is ready, not on a
                # client's request.
                prog = server.warm_run(key)
            except Exception:  # noqa: BLE001 - e.g. KernelBuildError
                fall("deserialize_failed")
                continue
            if server.warm_seed(key, prog):
                imported_c.inc()
                summary["imported"] += 1
            # A locally built entry already under this key wins; not a
            # fallback: nothing degraded.
    return summary


def dumps(envelope: dict) -> bytes:
    return json.dumps(envelope).encode("utf-8")


def loads(data: bytes) -> Optional[dict]:
    """Parse an envelope; None (→ ``payload_unavailable``) on garbage."""
    try:
        doc = json.loads(data)
    except Exception:  # noqa: BLE001
        return None
    return doc if isinstance(doc, dict) else None
