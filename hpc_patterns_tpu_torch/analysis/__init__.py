"""torchlint: static hazard analysis over the port — the counterpart of
``hpc_patterns_tpu/analysis/`` for the torch package and its CUDA
sources. Stdlib only: it never imports the code it reads (nor torch).

Four rule families (``--list-rules`` groups them):

- **torchlint** (``rules.py``): a host view of a tensor a later call
  writes in place (``inplace-alias``), a device readback inside a
  dispatch-critical function (``host-sync-in-dispatch``), a kernel
  build per call (``rebuild-hazard``), a generator re-seeded per call or
  a sampler key drawn twice at one position (``generator-reuse``), a
  graph kept alive on ``self`` or a ctx (``autograd-leak``);
- **shardlint** (``rules.py``): rank-dependent collective schedules
  over ``torch.distributed``, the ``Communicator`` and the gloo wire
  (``collective-divergence``, ``collective-order``), pair lists that
  skip ``comm.ring.check_permutation`` (``unchecked-permutation``),
  spec tuples against their mesh (``spec-mismatch``);
- **cudalint** (``cuda_rules.py``, ``smem.py``): a static ledger over
  ``csrc/`` — mbarrier arrivals and transaction bytes
  (``mbar-balance``), ring slots refilled before their empty barrier or
  credit (``ring-slot-reuse``), release/acquire flags
  (``flag-balance``), a widened accumulator stored without its cast
  (``kernel-dtype-cast``), and shared memory against the H100's
  per-block opt-in limit (``smem-budget``; ``--smem-report`` prints the
  table);
- **contractlint** (``contracts.py``, ``contract_rules.py``): the
  stringly-typed producer/consumer seams — gate keys, record kinds, the
  wire codec, trace bands, chaos names — judged over the port's tree.

Run it over the port (CI mode exits 1 on any unsuppressed finding)::

    python -m hpc_patterns_tpu_torch.analysis --ci

Runtime complements (``runtime.py``): ``poison_consumed`` /
``install_serving_poison`` fill the serving step's consumed inputs with a
sentinel after each call, ``strict_dispatch`` runs the statically clean
dispatch-critical functions under ``torch.cuda.set_sync_debug_mode
("error")``, ``strict_barriers`` runs the ledger build of kernels 11 and
14, and ``CollectiveSchedule`` (``harness/trace.py``) fingerprints every
eager collective.
"""

from __future__ import annotations

from hpc_patterns_tpu_torch.analysis.core import (  # noqa: F401
    AnalysisConfig,
    DEFAULT_DISPATCH_CRITICAL,
    Finding,
    Report,
    analyze_file,
    registered_rules,
    run_paths,
)


def dispatch_critical(fn):
    """Marker decorator: this function is on a dispatch-critical path
    (its job is to ENQUEUE device work, never to wait for it). Purely
    declarative — the wrapped function is returned unchanged — but the
    ``host-sync-in-dispatch`` rule audits every function carrying it,
    and ``runtime.strict_dispatch`` guards it on the card."""
    return fn
