"""PyTorch + CUDA port of ``hpc_patterns_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; module names mirror
it one for one so each part of the port has an obvious counterpart.
This package imports ``torch`` only — never ``jax`` and never anything
from ``hpc_patterns_tpu``.

Ported so far, with kernels written by hand for ``sm_90a``:

- the greedy paged serving path — ``models/serving.py``
  (``ContinuousBatcher``) over ``models/decode.py`` (paged prefill and
  decode); ``csrc/flash_prefill.cu`` (causal flash attention forward)
  and ``csrc/paged_decode.cu`` (single-query attention through a page
  table);
- the concurrency suite — ``concurrency/`` and ``apps/concurrency_app.py``,
  ``apps/sweep.py``, ``bench.py``; ``csrc/busy_wait.cu`` (the compute
  command's FMA chain) and ``csrc/overlap_pipeline.cu`` (bulk copies
  between global and shared memory racing the chain in one kernel);
- the communication suite over logical ranks on one card — ``comm/``
  (ring engine, collectives, ``Communicator``), ``apps/allreduce_app.py``,
  ``apps/pingpong_app.py``; ``csrc/fused_ring.cu`` (the fused ring
  allreduce, the all-gather matmul and the device-initiated permute, every
  rank a group of CTAs in one cooperative launch);
- interop — ``interop/`` and ``apps/interop_app.py``;
  ``csrc/alias_inplace.cu`` (an in-place kernel on a PyTorch buffer);
- single-device training — ``models/train.py`` (adamw + clip, the step),
  the loss in ``models/transformer.py``, ``utils/`` (data, checkpoints),
  ``apps/train_app.py`` and ``apps/eval_app.py``; the flash-attention
  backward ``csrc/flash_attention_bwd.cu`` (fused, dQ and dK/dV kernels)
  and the forward's logsumexp and global offsets in
  ``csrc/flash_prefill.cu``; the fused MLP ``csrc/fused_mlp.cu`` and the
  remat policies;
- the serving plane's KV handoff — the engine's migration half in
  ``models/serving.py``, ``serving_plane/`` (router, transports, wire
  codec), ``harness/loadgen.py``, ``harness/slo.py`` and
  ``bench_serving.py``; ``csrc/migration_dma.cu`` (the migration
  exchange between two logical ranks of one card);
- ranks beyond one process — ``apps/launch.py`` (the ``mpirun -np``
  analog; children join a gloo group, ``topology.
  init_distributed_from_env``), ``comm/processes.py`` (the block of
  logical ranks a process holds, rows between processes through pinned
  host memory), ``comm/halo.py`` and ``apps/stencil_app.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`hpc_patterns_tpu_torch.topology.resolve_device`).
"""
