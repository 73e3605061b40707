"""The child of ``tests/test_torch_launch.py``'s launched run: one process
of 2 x 2 logical ranks on the CPU (a gloo group). It runs
``allreduce_app --sweep`` at ``-p 8``, every ``Communicator`` collective
on numpy-seeded rows (written to ``<out>/rank<pid>.pt`` for the test to
hold against one process), the stencil app across the processes, and
last ``allreduce_app --algorithm fused``, whose exit code it returns.

    python tests/_torch_launch_worker.py OUT_DIR
"""

import os
import sys

import numpy as np
import torch

WORLD, N = 4, 64


def rows(seed, dtype=np.float32):
    """Every rank's numpy-seeded row, (WORLD, N)."""
    return np.random.default_rng(seed).standard_normal(
        (WORLD, N)).astype(dtype)


def collectives_of(comm):
    """Every collective of ``comm`` over the seeded rows it holds."""
    sl = slice(comm.rank_offset, comm.rank_offset + comm.local_size)

    def x(seed, dtype=torch.float32):
        return torch.from_numpy(rows(seed)[sl]).to(dtype)

    out = {f"allreduce.{a}": comm.allreduce(x(1), a)
           for a in ("ring", "ring_chunked", "collective")}
    out["allreduce.ring.bf16"] = comm.allreduce(x(2, torch.bfloat16), "ring")
    out["sendrecv_ring+1"] = comm.sendrecv_ring(x(3), 1)
    out["sendrecv_ring-1"] = comm.sendrecv_ring(x(3), -1)
    out["pingpong"] = comm.pingpong(x(4))
    out["all_gather"] = comm.all_gather(x(5))
    out["reduce_scatter"] = comm.reduce_scatter(x(6))
    out["all_to_all"] = comm.all_to_all(x(7))
    out["allreduce_into"] = comm.allreduce_into(
        x(8), bias=torch.ones(N), epilogue="relu", algorithm="collective")
    out["allgather_matmul"] = comm.allgather_matmul(
        x(9).reshape(-1, 8, 8), x(10).reshape(-1, 8, 8),
        algorithm="collective")
    return out


def main(out_dir: str) -> int:
    from hpc_patterns_tpu_torch.apps import allreduce_app, common, stencil_app

    assert allreduce_app.main(["--sweep", "--min-p", "8", "-p", "8",
                               "--device", "cpu", "--repetitions", "2",
                               "--warmup", "1"]) == 0
    comm = common.make_communicator("cpu")
    torch.save({k: v.clone() for k, v in collectives_of(comm).items()},
               os.path.join(out_dir, f"rank{comm.block.process_id}.pt"))
    assert stencil_app.main(["--device", "cpu", "-p", "10", "--steps", "16",
                             "--repetitions", "2", "--warmup", "1"]) == 0
    return allreduce_app.main(["--algorithm", "fused", "-p", "8",
                               "--device", "cpu"])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
