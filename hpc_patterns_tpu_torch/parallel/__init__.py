"""Parallelism strategies on the comm layer — the counterpart of
``hpc_patterns_tpu/parallel/__init__.py``, over logical ranks of one
device.

- :mod:`~.ring_attention` — context parallelism: the ring's
  exchange-and-accumulate with an online-softmax combine;
- :mod:`~.ulysses` — all-to-all sequence parallelism (heads scatter,
  sequence gathers around local full attention);
- :mod:`~.tensor` — Megatron-style tensor parallelism, the row-parallel
  reduction by the library allreduce or the hand ring;
- :mod:`~.moe` — mixture-of-experts, expert-parallel by two all-to-alls;
- :mod:`~.pipeline` — pipeline-parallel stage handoff: the pairwise pt2pt
  pattern as the fill-drain and 1F1B microbatch schedules.

JAX writes each as a rank-local function inside ``shard_map``; here each
takes the rank-stacked tensors (row r of the leading dim is rank r's
shard), as ``comm/`` does. The exports are JAX's but one: here
``parallel.ring_attention`` stays the submodule (its callers read its
names, ``full_attention`` and the mask constant, from it); the function
is ``parallel.ring_attention.ring_attention``.
"""

from hpc_patterns_tpu_torch.parallel.ulysses import (  # noqa: F401
    ulysses_attention,
)
from hpc_patterns_tpu_torch.parallel.tensor import (  # noqa: F401
    column_parallel,
    row_parallel,
    tp_mlp,
)
from hpc_patterns_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward,
    pipeline_train_1f1b,
    schedule_1f1b,
)
