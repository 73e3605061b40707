"""The serving plane of the port: a router over N engine replicas and the
KV handoff between them — the counterpart of
``hpc_patterns_tpu/serving_plane/``.

- ``router.py``    — the in-process plane: :class:`ServingPlane` routes
  an open-loop stream across :class:`Replica` engines
  (``role=both|prefill|decode``) with a placement policy, and migrates
  KV rows from prefill replicas to decode replicas over a transport
  tier (``dma``: kernel 13, ``comm/migration_dma.py``; ``device_put``;
  ``wire``), the install enqueued behind the destination's decode
  chunk.
- ``migration.py`` — the transfer between two engines: ``migrate_pages``
  and the wire codec, byte-compatible with the JAX package's.
- ``autoscaler.py`` — the autoscaler: the pure controller
  (:class:`Autoscaler`, :class:`AutoscalerPolicy`), which
  ``harness/autofit.py`` replays offline, the residency-backed warm
  weights (:class:`WarmParamPool`) and the elastic plane
  (:class:`ElasticServingPlane`: warm spin-up, drain by migration,
  checkpoint-resume of a dead replica's rows).
- ``service.py``   — the launched plane: replica processes behind a
  newline-JSON socket protocol (stub and real engines) and the router
  process (``PlaneRouter``), driven by ``apps/plane_app.py`` under
  ``apps/launch.py``; it imports no torch at module level.

This ``__init__`` stays lazy, as JAX's does.
"""

from __future__ import annotations

_LAZY = {
    "Replica": "hpc_patterns_tpu_torch.serving_plane.router",
    "ServingPlane": "hpc_patterns_tpu_torch.serving_plane.router",
    "PLACEMENT_POLICIES": "hpc_patterns_tpu_torch.serving_plane.router",
    "MIGRATION_TRANSPORTS": "hpc_patterns_tpu_torch.serving_plane.router",
    "Autoscaler": "hpc_patterns_tpu_torch.serving_plane.autoscaler",
    "AutoscalerPolicy": "hpc_patterns_tpu_torch.serving_plane.autoscaler",
    "ElasticServingPlane": "hpc_patterns_tpu_torch.serving_plane.autoscaler",
    "WarmParamPool": "hpc_patterns_tpu_torch.serving_plane.autoscaler",
    "migrate_pages": "hpc_patterns_tpu_torch.serving_plane.migration",
    "bundle_to_wire": "hpc_patterns_tpu_torch.serving_plane.migration",
    "bundle_from_wire": "hpc_patterns_tpu_torch.serving_plane.migration",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(mod), name)
