"""The port's launcher (``hpc_patterns_tpu_torch/apps/launch.py``) and its
cross-process communicator against the JAX package on the CPU.

JAX's own tier-1 bodies of ``tests/test_launch.py`` (``TestLauncherMechanics``,
``TestCollectiveScheduleLaunch``, ``TestChaosLaunch``,
``TestDistributedTraceMerge``, ``TestServingPlaneLaunch``) run unchanged on
the port's launcher (the serving plane's on the port's ``plane_app``). Their
children are command lines naming JAX's modules; :class:`_PortLaunch`
hands the port's launcher the same command with every module the port
has a counterpart of named instead (``analysis.runtime``'s collective
chain lives in the port's ``harness/trace.py``; an app child also gets
``--device cpu``). The mechanics children import no torch.

Then one launch of 2 processes x 2 logical ranks (a gloo group on the
CPU) runs, in each child (``tests/_torch_launch_worker.py``):
``allreduce_app --sweep`` (ring, ring_chunked
and collective at ``-p 8``; ``fused`` named as not run), every
``Communicator`` collective on numpy-seeded f32 rows (and the ring on
bf16), written per process and held bit for bit against the same
communicator in one process with 4 ranks, the stencil app across the two
processes (both oracles, equal to its dense replay bit for bit), and
last ``allreduce_app --algorithm fused``, which must exit 2 with the
reason.
"""

import sys

import pytest
import torch

import _torch_launch_worker as worker
import _torch_parity as parity
from hpc_patterns_tpu_torch.apps import launch as tlaunch
from hpc_patterns_tpu_torch.comm.communicator import Communicator

#: JAX module names in a child's command -> the port's
CHILD_NAMES = (
    ("from hpc_patterns_tpu.analysis import runtime as rt",
     "from hpc_patterns_tpu_torch.harness import trace as rt"),
    ("hpc_patterns_tpu.", "hpc_patterns_tpu_torch."),
)


def _port_command(argv):
    """``argv`` with the child's command naming the port's modules."""
    if "--" not in argv:
        return argv
    cut = argv.index("--") + 1
    cmd = list(argv[cut:])
    if len(cmd) >= 3 and cmd[1] == "-c":
        for jax_name, port_name in CHILD_NAMES:
            cmd[2] = cmd[2].replace(jax_name, port_name)
    elif len(cmd) >= 3 and cmd[1] == "-m":
        cmd[2] = cmd[2].replace("hpc_patterns_tpu.", "hpc_patterns_tpu_torch.")
        if cmd[2].startswith("hpc_patterns_tpu_torch.apps."):
            cmd.insert(3, "cpu")
            cmd.insert(3, "--device")
    return argv[:cut] + cmd


class _PortLaunch:
    """The port's launch module, children renamed (module docstring)."""

    @staticmethod
    def main(argv=None):
        return tlaunch.main(_port_command(list(argv)))


BODIES = parity.load("test_launch")
BODIES.launch = _PortLaunch
CASES = parity.cases(BODIES, ["TestLauncherMechanics",
                              "TestCollectiveScheduleLaunch",
                              "TestChaosLaunch",
                              "TestServingPlaneLaunch"])


@pytest.mark.parametrize("cls,method", CASES)
def test_jax_body_on_the_port(cls, method, request):
    parity.call(BODIES, cls, method, request)


@pytest.fixture(scope="module")
def merged_run(tmp_path_factory):
    """JAX's one traced 2-process allreduce_app launch, on the port."""
    fixture = vars(BODIES.TestDistributedTraceMerge)["merged_run"]
    return fixture.__wrapped__(None, tmp_path_factory)


MERGE_CASES = parity.cases(BODIES, ["TestDistributedTraceMerge"])


@pytest.mark.parametrize("cls,method", MERGE_CASES)
def test_jax_trace_merge_body_on_the_port(cls, method, merged_run,
                                          request):
    parity.call(BODIES, cls, method, request, merged_run=merged_run)


def test_launched_real_engine_plane(tmp_path, capsys):
    # the real-engine shape of JAX's disaggregated stub plane: a router
    # and one prefill + one decode replica serving the default tiny model
    # on the CPU, every request crossing the KV handoff over the socket
    code = tlaunch.main([
        "-np", "3", "--timeout", "120", "--",
        sys.executable, "-m", "hpc_patterns_tpu_torch.apps.plane_app",
        "--roles", "prefill,decode", "--rdv", str(tmp_path / "rdv"),
        "--requests", "4", "--rate", "10000", "--device", "cpu",
        "--plane-timeout", "100",
    ])
    printed = capsys.readouterr().out
    assert code == 0, printed
    assert "PLANE SUCCESS" in printed
    assert "served 4/4" in printed and "migrations=4" in printed


def test_launcher_imports_no_torch():
    import subprocess

    code = ("import sys; import hpc_patterns_tpu_torch.apps.launch; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "False"


# ---------------------------------------------------------------------------
# 2 processes x 2 logical ranks against 1 process x 4


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    out = tmp_path_factory.mktemp("launched")
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        code = tlaunch.main([
            "-np", "2", "--cpu-devices-per-proc", "2", "--timeout", "300",
            "--", sys.executable, str(parity.TESTS / "_torch_launch_worker.py"),
            str(out)])
    return code, buf.getvalue(), out


def test_launched_allreduce_passes_every_rank_with_the_wire_named(launched):
    code, out, _ = launched
    for r in range(worker.WORLD):
        assert out.count(f"] Passed {r}") >= 3, out  # ring, chunked, coll
    assert out.count("sweep: 3/3 points passed (world=4, p=8..8, "
                     "algorithms=ring,ring_chunked,collective)") == 2, out
    assert ("collectives: 2 processes x 2 logical rank(s) (this process: "
            "ranks 2..3), across processes over gloo over host memory"
            in out)
    assert out.count("fused: not run across processes") >= 2


def test_launched_collectives_equal_one_process_bit_for_bit(launched):
    _, out, path = launched
    got = [torch.load(path / f"rank{p}.pt") for p in range(2)]
    want = worker.collectives_of(Communicator({"x": worker.WORLD}, "x",
                                              device="cpu"))
    assert set(got[0]) == set(want)
    for name, w in want.items():
        g = torch.cat([got[0][name], got[1][name]])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g.view(torch.uint8) if g.dtype == torch.bfloat16
                           else g, w.view(torch.uint8)
                           if w.dtype == torch.bfloat16 else w), name


def test_launched_stencil_equals_its_dense_replay(launched):
    _, out, _ = launched
    lines = [x for x in out.splitlines() if "] stencil world=4" in x]
    assert len(lines) == 2, out
    assert all("conserved=True dense-match=True dense-bitwise=True" in x
               for x in lines)
    assert "[0] Passed 0" in out and "[1] Passed 3" in out


def test_launched_fused_is_refused_with_exit_2(launched):
    code, out, _ = launched
    assert code == 1
    assert "launch -np 2: exit codes [2, 2]" in out
    assert out.count("ERROR: --algorithm fused across processes is refused:"
                     " the fused routes run every rank's CTAs in one "
                     "cooperative launch") == 2


def test_fused_route_refused_in_the_communicator():
    from hpc_patterns_tpu_torch.comm.processes import RankBlock

    comm = Communicator({"x": 4}, "x", device="cpu",
                        block=RankBlock(4, 2, 0, 2))
    assert comm.local_size == 2 and comm.rank_offset == 0
    for call in (lambda: comm.jit_allreduce(torch.zeros(2, 4), "fused"),
                 lambda: comm.jit_pingpong(torch.zeros(2, 4), "fused"),
                 lambda: comm.allreduce_into(torch.zeros(2, 4)),
                 lambda: comm.allgather_matmul(torch.zeros(2, 2, 2),
                                               torch.zeros(2, 2, 2))):
        with pytest.raises(ValueError, match="time-sliced, not co-resident"):
            call()
    with pytest.raises(ValueError, match="rank"):
        comm.shard(torch.zeros(4, 4))  # the rows of every rank
