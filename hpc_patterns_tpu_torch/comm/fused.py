"""Device-initiated ring collectives over logical ranks — the counterpart
of ``hpc_patterns_tpu/comm/fused.py``.

The JAX kernels run the ring inside one Pallas kernel per chip, each hop
a remote DMA to the neighbour chip. The port has one card and runs every
rank inside one CUDA kernel (``csrc/fused_ring.cu``): each rank is a
group of CTAs, a hop is a store into the right neighbour's receive slot
in global memory plus a release/acquire flag (the allreduce's slots a
small FIFO a link reuses under credits, sized by
:func:`allreduce_plan` to stay in the L2). So every
function here takes the **global** tensor, not a rank-local shard: a
``(ranks, ...)`` tensor whose row ``r`` is rank ``r``'s buffer.

Kernels and their plain versions (same module):

- :func:`fused_allreduce` / :func:`allreduce_into` — the two-phase ring
  with a fused bias and named epilogue; plain: :func:`fused_allreduce_reference`
  (``ring.ring_allreduce_chunked`` over the :func:`ring_layout`-padded
  tensor), bitwise equal to the kernel for f32, bf16 and int32 when it
  is given the card's ``lane`` (:data:`CARD_LANE`);
- :func:`allgather_matmul` — ring all-gather whose arriving shards feed
  f32-accumulated matmul tiles; plain: :func:`allgather_matmul_reference`;
- :func:`fused_permute` / :func:`fused_ring_shift` — a device-initiated
  permutation of rows; plain: :func:`fused_permute_reference`.

On CUDA tensors the wrappers launch the kernels (or raise); on CPU tensors
they compute the plain versions. Each launch adds one to its entry of
:data:`launches`. A ring spin that times out inside a kernel sets an error
word in mapped host memory; :func:`synchronize` (and the next wrapper call)
raises on it, so a protocol fault fails the run instead of hanging it.

Multi-axis meshes: as in JAX, a ring over one axis of a multi-axis mesh is
a :class:`RingGeometry` over the flat (row-major) rank order: ring
neighbour of flat rank ``f`` at position ``p = (f // stride) % size`` is
``f + ((p + 1) % size - p) * stride``; ranks sharing a position are
replicas running the identical schedule. Stride and total reach the
kernels as arguments.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import torch

from hpc_patterns_tpu_torch.comm import ring
from hpc_patterns_tpu_torch.ops import _build

#: reduce ops the fused ring implements; ``prod`` stays on the host route
#: (``collectives.allreduce(op="prod")``, gather-then-product)
FUSED_REDUCE_OPS = frozenset({"sum"})

#: the card's chunk-width multiple, in elements: 16-byte vectors for bf16
#: (and two for f32/int32). The plain version the kernel is held against
#: takes the same lane; the CPU route uses 1, JAX's interpret-mode lane.
CARD_LANE = 8

#: epilogues the allreduce kernel fuses, by name (its ``epilogue`` code)
KERNEL_EPILOGUES = {None: 0, "relu": 1}

#: a ring spin inside a kernel gives up after this long (then the launch
#: aborts and :func:`synchronize` raises)
SPIN_TIMEOUT_NS = 1_000_000_000

#: the all-gather matmul kernel's output tile (rows, columns): each CTA
#: owns one tile of its rank for every ring step (csrc/fused_ring.cu's
#: AG_BM, AG_BN)
AGMM_TILE = (128, 64)

#: the allreduce's hop: one tile of a CTA's stripe, in 16-byte vectors,
#: and its receive slots a ring link (csrc/fused_ring.cu's AR_TILE, 128
#: threads x 4 = 8 KiB, and AR_SLOTS, which its fused_allreduce_config
#: reports), and the bytes all of a launch's slots may take together:
#: well inside the H100's 50 MB L2, so a partial is written and read
#: there and never reaches DRAM. On an H100 at 2^25 f32 x 4 ranks more
#: budget, slots or slack did not help (PERF.md)
ALLREDUCE_TILE_VECTORS = 512
ALLREDUCE_SLOTS = 4
ALLREDUCE_FIFO_BUDGET = 16 << 20
#: u32 words a FIFO counter takes (its own 128-byte line; FLAG_WORDS)
FIFO_FLAG_WORDS = 32

#: kernel launches in this process, by kernel (the main-path witness)
launches = {"fused_allreduce": 0, "allgather_matmul": 0, "fused_permute": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_KERNEL_IDS = {"fused_allreduce": 0, "allgather_matmul": 1, "fused_permute": 2}
_THREADS = 256
_STATUS = {1: "allreduce reduce-scatter phase", 2: "allreduce gather phase",
           3: "allgather_matmul", 4: "fused_permute",
           5: "allreduce FIFO credit"}

# scratch of the kernels (receive slots, flags, epoch): one geometry per
# kernel, dropped when a call of another geometry comes, so no slots of an
# earlier shape stay allocated. Launches that share an entry must run in
# order (one stream), as the epochs count them.
_scratch: dict = {}
# co-resident CTAs per (kernel, dtype code, device)
_capacity_cache: dict = {}


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """How one logical ring sits inside a flat rank order: ``size`` ring
    positions, ``stride`` the flat distance between consecutive positions,
    ``total`` the flat rank count (``size * stride`` by default). The
    identity geometry (``stride=1, total=size``) is a 1-D mesh."""

    size: int
    stride: int = 1
    total: int | None = None

    def __post_init__(self):
        if self.total is None:
            object.__setattr__(self, "total", self.size * self.stride)
        if self.size < 1 or self.stride < 1:
            raise ValueError(f"degenerate ring geometry: {self}")
        if self.total % (self.size * self.stride):
            raise ValueError(
                f"flat size {self.total} not divisible by "
                f"size*stride = {self.size * self.stride}: {self}")

    def positions(self) -> list[int]:
        """Ring position of every flat rank — the index that expands a
        ``(size, ...)`` tensor to its ``(total, ...)`` replicated layout."""
        return [(f // self.stride) % self.size for f in range(self.total)]

    def ring_ids(self) -> list[int]:
        """One representative flat rank per ring position (the fold-back
        selection)."""
        return [p * self.stride for p in range(self.size)]

    def rings(self) -> list[list[int]]:
        """The flat ranks of every ring, each in position order."""
        bases = sorted({f - ((f // self.stride) % self.size) * self.stride
                        for f in range(self.total)})
        return [[b + q * self.stride for q in range(self.size)]
                for b in bases]

    def flat_dst_table(self, dst_by_pos: Sequence[int]) -> list[int]:
        """A position-level destination table expanded to flat ranks:
        each flat rank sends to the same replica of its destination."""
        out = []
        for f in range(self.total):
            pos = (f // self.stride) % self.size
            out.append(f + (int(dst_by_pos[pos]) - pos) * self.stride)
        return out


def mesh_ring_geometry(mesh_shape: dict, axis: str) -> RingGeometry:
    """The geometry of ring ``axis`` in a mesh of ``{name: size}`` laid out
    row-major: stride = product of the axis sizes to its right."""
    names = list(mesh_shape)
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    sizes = [int(mesh_shape[a]) for a in names]
    i = names.index(axis)
    return RingGeometry(size=sizes[i], stride=int(math.prod(sizes[i + 1:])),
                        total=int(math.prod(sizes)))


def _resolve_geometry(x: torch.Tensor, geometry: RingGeometry | None
                      ) -> RingGeometry:
    g = geometry if geometry is not None else RingGeometry(size=x.shape[0])
    if x.shape[0] != g.total:
        raise ValueError(
            f"leading dim {x.shape[0]} != the geometry's {g.total} ranks")
    ring.check_permutation(ring._ring_perm(g.size, 1), g.size)
    return g


def _check_op(op: str) -> None:
    if op not in FUSED_REDUCE_OPS:
        raise ValueError(
            f"fused allreduce implements {sorted(FUSED_REDUCE_OPS)}, got "
            f"{op!r} — notably 'prod' must stay on the host path "
            "(collectives.allreduce op='prod'), whose gather-then-product "
            "is the only exact route")


def ring_layout(shape: Sequence[int], size: int, lane: int = 1
                ) -> tuple[int, int, int, int]:
    """Chunk geometry shared by the kernel, its plain version and the
    tests: ``(m, n, cn, n_pad)`` for a rank's shard ``shape`` flattened to
    ``(m, n)``. ``cn`` is the ring chunk width, ``ceil(n / size)`` rounded
    up to a multiple of ``lane``, and ``n_pad = size * cn`` the padded
    column count the two-phase ring runs over. The chunk layout decides
    which rank starts each column's sum, so kernel and plain version must
    share ``lane`` to agree bit for bit (JAX's interpret mode: lane 1)."""
    shape = tuple(shape) or (1,)
    n = shape[-1]
    m = math.prod(shape[:-1]) if len(shape) > 1 else 1
    cn = max(1, -(-n // size))
    cn = -(-cn // lane) * lane
    return m, n, cn, size * cn


def _apply_epilogue(v: torch.Tensor, epilogue) -> torch.Tensor:
    if epilogue is None:
        return v
    if epilogue == "relu":
        return torch.relu(v)
    return epilogue(v)


def _kernel_epilogue(epilogue) -> int:
    """The kernel's code for ``epilogue``: None or ``"relu"`` (also
    ``torch.relu`` / ``torch.nn.functional.relu``). Any other callable
    cannot enter a CUDA kernel."""
    if epilogue in (torch.relu, torch.nn.functional.relu):
        epilogue = "relu"
    if isinstance(epilogue, str) or epilogue is None:
        if epilogue not in KERNEL_EPILOGUES:
            raise ValueError(f"unknown epilogue {epilogue!r}; the kernel "
                             f"fuses {sorted(map(str, KERNEL_EPILOGUES))}")
        return KERNEL_EPILOGUES[epilogue]
    raise NotImplementedError(
        f"epilogue {epilogue!r}: the allreduce kernel fuses only a bias add "
        "and the named epilogues None and 'relu'; other callables run on the "
        "CPU plain path only (queued in ROADMAP.md)")


# ---------------------------------------------------------------------------
# the library, its status word and scratch
# ---------------------------------------------------------------------------


def _lib():
    lib = _build.load("fused_ring")
    if not getattr(lib, "_fused_ring_ready", False):
        vp, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_uint)
        lib.fused_ring_init.restype = i
        lib.fused_ring_status.restype = u
        lib.fused_ring_clear_status.restype = None
        lib.fused_ring_capacity.argtypes = [i, i, ctypes.POINTER(i)]
        lib.fused_ring_capacity.restype = i
        lib.fused_allreduce_fifo.argtypes = [vp, vp, vp, vp, vp, vp, u, i, i,
                                             i, i, ll, ll, ll, i, i, ll, i,
                                             vp]
        lib.fused_allreduce_fifo.restype = i
        lib.fused_allreduce_config.argtypes = [ctypes.POINTER(i)]
        lib.fused_allreduce_config.restype = None
        lib.allgather_matmul.argtypes = [vp, vp, vp, vp, vp, vp, u, i, i, i,
                                         i, ll, ll, ll, i, ll, vp]
        lib.allgather_matmul.restype = i
        lib.fused_permute.argtypes = [vp, vp, vp, vp, vp, u, i, ll, i, ll, vp]
        lib.fused_permute.restype = i
        lib.allgather_matmul_config.argtypes = [ctypes.POINTER(i)]
        lib.allgather_matmul_config.restype = None
        _build.check(lib.fused_ring_init(), "fused_ring_init")
        lib._fused_ring_ready = True
    return lib


def _raise_on_status(lib) -> None:
    code = lib.fused_ring_status()
    if code:
        lib.fused_ring_clear_status()
        # a launch that aborted leaves its counters part-filled: start
        # every scratch afresh
        _scratch.clear()
        raise RuntimeError(
            f"fused ring kernel: a spin timed out in the "
            f"{_STATUS.get(code, f'kernel with code {code}')} (a rank "
            "never sent); the launch aborted")


def synchronize(device=None) -> None:
    """Wait for the card, then raise if a fused ring launch timed out."""
    torch.cuda.synchronize(device)
    if _build.is_loaded("fused_ring"):
        _raise_on_status(_lib())


def _capacity(kernel: str, dtype_code: int) -> int:
    """Co-resident CTAs of ``kernel`` on the current device (the
    cooperative launch's ceiling), asked once per (kernel, dtype,
    device): the occupancy query costs host time on every call
    otherwise."""
    key = (kernel, dtype_code, torch.cuda.current_device())
    cap = _capacity_cache.get(key)
    if cap is None:
        c = ctypes.c_int(0)
        _build.check(_lib().fused_ring_capacity(_KERNEL_IDS[kernel],
                                                dtype_code, ctypes.byref(c)),
                     "fused_ring_capacity")
        cap = _capacity_cache[key] = c.value
    return cap


def _per_rank(kernel: str, capacity: int, ranks: int) -> int:
    per_rank = capacity // ranks
    if per_rank < 1:
        raise ValueError(
            f"{ranks} ranks exceed the {capacity} co-resident CTAs of the "
            f"{kernel} kernel")
    return per_rank


def _grid(kernel: str, dtype_code: int, ranks: int, work_units: int) -> int:
    """CTAs per rank: as many as are co-resident for all ranks at once
    (the cooperative launch's ceiling), but no more than the work needs."""
    per_rank = _per_rank(kernel, _capacity(kernel, dtype_code), ranks)
    return max(1, min(per_rank, work_units))


def _get_scratch(key, make):
    """The scratch of geometry ``key`` (``key[0]`` names the kernel), with
    its epoch advanced for one launch."""
    s = _scratch.get(key[0])
    if s is None or s["key"] != key:
        _scratch.pop(key[0], None)  # free the old slots before the new
        s = _scratch[key[0]] = make()
        s["key"], s["epoch"] = key, 0
    s["epoch"] = (s["epoch"] + 1) & 0xFFFFFFFF or 1
    return s


def _dtype_code(x: torch.Tensor, name: str) -> int:
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32, bfloat16 or int32, "
                         f"got {x.dtype}")
    return _DTYPE_CODES[x.dtype]


# ---------------------------------------------------------------------------
# fused_allreduce / allreduce_into
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, m: int, n: int, n_pad: int) -> torch.Tensor:
    x2 = x.reshape(x.shape[0], m, n)
    if n_pad != n:
        x2 = torch.nn.functional.pad(x2, (0, n_pad - n))
    return x2.contiguous()


def _bias_rows(bias, shard_shape, dtype, device, m, n, n_pad):
    b = torch.as_tensor(bias, device=device).to(dtype)
    b = torch.broadcast_to(b, tuple(shard_shape)).reshape(m, n)
    if n_pad != n:
        b = torch.nn.functional.pad(b, (0, n_pad - n))
    return b.contiguous()


def fused_allreduce_reference(x: torch.Tensor, *, bias=None, epilogue=None,
                              geometry: RingGeometry | None = None,
                              lane: int = 1) -> torch.Tensor:
    """The plain version: the chunked two-phase ring of
    ``ring.ring_allreduce_chunked`` over the :func:`ring_layout`-padded
    tensor (every ring of ``geometry`` on its own), then ``epilogue(sum +
    bias)`` in ``x``'s dtype, the pad sliced off."""
    g = _resolve_geometry(x, geometry)
    shard = x.shape[1:]
    if g.size == 1:
        out = x if bias is None else x + torch.as_tensor(
            bias, device=x.device).to(x.dtype)
        return _apply_epilogue(out, epilogue).to(x.dtype)
    m, n, cn, n_pad = ring_layout(shard, g.size, lane)
    xp = _pad_rows(x, m, n, n_pad)
    out = torch.empty_like(xp)
    for members in g.rings():
        idx = torch.tensor(members, device=x.device)
        out[idx] = ring.ring_allreduce_chunked(xp[idx], scatter_axis=1)
    if bias is not None:
        out = out + _bias_rows(bias, shard, x.dtype, x.device, m, n, n_pad)
    out = _apply_epilogue(out, epilogue).to(x.dtype)
    return out[..., :n].reshape(x.shape)


def fused_allreduce(x: torch.Tensor, *, op: str = "sum", bias=None,
                    epilogue=None, geometry: RingGeometry | None = None
                    ) -> torch.Tensor:
    """Ring allreduce(sum) of the rows of ``x`` (global ``(ranks, *shard)``
    tensor) with the whole two-phase schedule inside one kernel; every row
    of the result holds ``epilogue(sum + bias)`` in ``x``'s dtype. CUDA:
    the kernel (float32, bfloat16, int32; epilogue None or ``"relu"``;
    chunks padded to :data:`CARD_LANE`). CPU:
    :func:`fused_allreduce_reference` at lane 1, JAX's interpret-mode
    layout."""
    _check_op(op)
    g = _resolve_geometry(x, geometry)
    if x.device.type == "cpu":
        return fused_allreduce_reference(x, bias=bias, epilogue=epilogue,
                                         geometry=g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _fused_allreduce_launch(x, bias, epilogue, g,
                                   ranks_launched=g.total)


@dataclasses.dataclass(frozen=True)
class AllreducePlan:
    """The allreduce kernel's launch: ``ctas_a_rank`` CTAs a rank, each
    running the ring over one stripe of every chunk in at most ``tiles``
    tiles of :data:`ALLREDUCE_TILE_VECTORS` 16-byte vectors; the scratch
    is the FIFO (``fifo_bytes``: :data:`ALLREDUCE_SLOTS` slots a ring
    link) and two counters a link (``flag_words`` u32: tiles arrived,
    tiles consumed), which run on from launch to launch."""

    ctas_a_rank: int
    tiles: int
    fifo_bytes: int
    flag_words: int


def allreduce_plan(total: int, chunk_vectors: int, capacity: int, *,
                   ctas_a_rank: int | None = None) -> AllreducePlan:
    """The FIFO ring's plan for ``total`` flat ranks, chunks of
    ``chunk_vectors`` 16-byte vectors, on a card that holds ``capacity``
    co-resident CTAs of the kernel: as many CTAs a rank as are
    co-resident and have a tile of work, no more than keep every link's
    slots within :data:`ALLREDUCE_FIFO_BUDGET`. ``ctas_a_rank`` forces
    fewer (the card tests' stripes of many tiles). Raises when the card
    cannot hold one CTA per rank."""
    link = ALLREDUCE_SLOTS * ALLREDUCE_TILE_VECTORS * 16
    fit = ALLREDUCE_FIFO_BUDGET // (total * link)
    G = max(1, min(_per_rank("fused_allreduce", capacity, total),
                   ctas_a_rank or -(-chunk_vectors // ALLREDUCE_TILE_VECTORS),
                   fit))
    return AllreducePlan(
        ctas_a_rank=G, tiles=-(-(-(-chunk_vectors // G))
                               // ALLREDUCE_TILE_VECTORS),
        fifo_bytes=total * G * link,
        flag_words=total * G * 2 * FIFO_FLAG_WORDS)


def allreduce_scratch(plan: AllreducePlan, device) -> dict:
    """The allreduce's scratch for ``plan``: its FIFO, its counters (at
    0) and the abort word."""
    return {"fifo": torch.empty(plan.fifo_bytes, dtype=torch.uint8,
                                device=device),
            "flags": torch.zeros(plan.flag_words, dtype=torch.int32,
                                 device=device),
            "abort": torch.zeros(1, dtype=torch.int32, device=device)}


def _fused_allreduce_launch(x, bias, epilogue, g: RingGeometry, *,
                            ranks_launched: int,
                            ctas_a_rank: int | None = None) -> torch.Tensor:
    code = _dtype_code(x, "fused_allreduce")
    epi = _kernel_epilogue(epilogue)
    shard = x.shape[1:]
    if g.size == 1:
        return fused_allreduce_reference(x, bias=bias, epilogue=epilogue,
                                         geometry=g)
    vec = 16 // x.element_size()  # CARD_LANE is a multiple of it
    lib = _lib()
    _raise_on_status(lib)
    m, n, cn, n_pad = ring_layout(shard, g.size, CARD_LANE)
    xp = _pad_rows(x, m, n, n_pad)
    bp = (None if bias is None
          else _bias_rows(bias, shard, x.dtype, x.device, m, n, n_pad))
    plan = allreduce_plan(g.total, m * cn // vec,
                          _capacity("fused_allreduce", code),
                          ctas_a_rank=ctas_a_rank)
    s = _get_scratch(("allreduce", x.device, g, m, cn, x.dtype, plan),
                     lambda: allreduce_scratch(plan, x.device))
    out = torch.empty_like(xp)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_allreduce_fifo(
            xp.data_ptr(), None if bp is None else bp.data_ptr(),
            out.data_ptr(), s["fifo"].data_ptr(), s["flags"].data_ptr(),
            s["abort"].data_ptr(), s["epoch"], code, g.size, g.stride,
            g.total, m, cn, n_pad, plan.ctas_a_rank, epi, SPIN_TIMEOUT_NS,
            ranks_launched, stream)
    _build.check(rc, "fused_allreduce")
    launches["fused_allreduce"] += 1
    return out[..., :n].reshape(x.shape)


def allreduce_into(x: torch.Tensor, *, bias=None, epilogue=None,
                   geometry: RingGeometry | None = None) -> torch.Tensor:
    """Allreduce with its consumer fused into the gather phase: each
    reduced chunk gets ``epilogue(chunk + bias)`` as it lands. The
    epilogue must be elementwise; the kernel takes None or ``"relu"``."""
    return fused_allreduce(x, bias=bias, epilogue=epilogue,
                           geometry=geometry)


# ---------------------------------------------------------------------------
# allgather_matmul
# ---------------------------------------------------------------------------


def _check_agmm(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or x.shape[2] != w.shape[1] \
            or x.shape[0] != w.shape[0]:
        raise ValueError(
            f"allgather_matmul wants x (ranks, m, k) @ w (ranks, k, n), got "
            f"{tuple(x.shape)} @ {tuple(w.shape)}")


def allgather_matmul_reference(x: torch.Tensor, w: torch.Tensor, *,
                               geometry: RingGeometry | None = None
                               ) -> torch.Tensor:
    """The plain version: the gather completes, then every tile is one
    f32-accumulated product cast to ``x``'s dtype. Row r of the result is
    ``concat_j(x[j]) @ w[r]`` over the ranks j of r's ring, in position
    order: ``(ranks, size*m, n)``."""
    _check_agmm(x, w)
    g = _resolve_geometry(x, geometry)
    out = torch.empty(g.total, g.size * x.shape[1], w.shape[2],
                      dtype=x.dtype, device=x.device)
    for members in g.rings():
        idx = torch.tensor(members, device=x.device)
        gathered = x[idx].reshape(-1, x.shape[2]).float()
        out[idx] = torch.matmul(gathered[None], w[idx].float()).to(x.dtype)
    return out


def allgather_matmul_tolerance(x: torch.Tensor, w: torch.Tensor,
                               want: torch.Tensor, *,
                               geometry: RingGeometry | None = None
                               ) -> torch.Tensor:
    """The stated elementwise bound on kernel vs plain for
    :func:`allgather_matmul` (``want``: the plain result). Both sides sum
    the k products in f32, in different orders; each lies within
    ``4·sqrt(k)·2^-24·Σ|x||w|`` of the exact sum (the probabilistic
    rounding bound at λ = 4), so their difference within twice that. TF32
    rounds every input to 2^-11, 2^13 times f32's unit roundoff, and fails
    it.
    bfloat16 adds one ulp of the output (two f32 sums either side of a
    rounding boundary); int32 (small values, exact in f32) gets 0."""
    if not want.is_floating_point():
        return torch.zeros(want.shape, device=want.device)
    k = x.shape[2]
    mag = allgather_matmul_reference(x.float().abs(), w.float().abs(),
                                     geometry=geometry)
    tol = 8.0 * math.sqrt(k) * 2.0 ** -24 * mag
    if want.dtype == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -7
    return tol


def agmm_plan(total: int, m: int, n: int, capacity: int
              ) -> tuple[int, int, int, int]:
    """The all-gather matmul's launch plan: ``(BM, BN, G, waves)``. Each
    rank's (m, n) product is cut into :data:`AGMM_TILE` tiles; ``G``
    CTAs a rank (all ``total * G`` co-resident, within ``capacity``) each
    own ``waves`` of them at every ring step, so ``waves`` is 1 when the
    grid holds a CTA per tile. Raises when the card cannot hold one CTA
    per rank."""
    bm, bn = AGMM_TILE
    tiles = -(-m // bm) * -(-n // bn)
    G = max(1, min(_per_rank("allgather_matmul", capacity, total), tiles))
    return bm, bn, G, -(-tiles // G)


def allgather_matmul(x: torch.Tensor, w: torch.Tensor, *,
                     geometry: RingGeometry | None = None) -> torch.Tensor:
    """``all_gather(x) @ w`` with the gather ring inside the kernel: each
    shard that arrives is forwarded to the next rank, then multiplied by
    the local panel. ``x``: ``(ranks, m, k)``, ``w``: ``(ranks, k, n)``;
    returns ``(ranks, size*m, n)`` with row-block j of row r equal to
    ``x[j] @ w[r]``. CUDA: the kernel (f32 FFMA accumulation for float32,
    bfloat16 and int32 inputs, cast to the input dtype). CPU:
    :func:`allgather_matmul_reference`."""
    _check_agmm(x, w)
    g = _resolve_geometry(x, geometry)
    if x.device.type == "cpu":
        return allgather_matmul_reference(x, w, geometry=g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    code = _dtype_code(x, "allgather_matmul")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError("allgather_matmul wants w on x's device and dtype")
    if g.size == 1:
        return allgather_matmul_reference(x, w, geometry=g)
    _, m, k = x.shape
    n = w.shape[2]
    if (m * k * x.element_size()) % 16:
        raise ValueError(f"allgather_matmul kernel wants m*k*itemsize a "
                         f"multiple of 16 bytes, got {m}x{k} {x.dtype}")
    lib = _lib()
    _raise_on_status(lib)
    x = x.contiguous()
    w = w.contiguous()
    _, _, G, _ = agmm_plan(g.total, m, n, _capacity("allgather_matmul", code))
    S = g.size - 1

    def make():
        return {"buf": torch.empty(g.total * S * m * k, dtype=x.dtype,
                                   device=x.device),
                "counters": torch.zeros(g.total * S, dtype=torch.int32,
                                        device=x.device),
                "abort": torch.zeros(1, dtype=torch.int32, device=x.device)}

    s = _get_scratch(("allgather_matmul", x.device, g, m, k, x.dtype, G),
                     make)
    out = torch.empty(g.total, g.size * m, n, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.allgather_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), s["buf"].data_ptr(),
            s["counters"].data_ptr(), s["abort"].data_ptr(), s["epoch"],
            code, g.size, g.stride, g.total, m, k, n, G, SPIN_TIMEOUT_NS,
            stream)
    _build.check(rc, "allgather_matmul")
    launches["allgather_matmul"] += 1
    return out


# ---------------------------------------------------------------------------
# fused_permute
# ---------------------------------------------------------------------------


def _dst_table(perm, g: RingGeometry) -> list[int]:
    perm = [(int(s), int(d)) for s, d in perm]
    ring.check_permutation(perm, g.size)
    dst = [0] * g.size
    for s, d in perm:
        dst[s] = d
    return g.flat_dst_table(dst)


def fused_permute_reference(x: torch.Tensor, perm, *,
                            geometry: RingGeometry | None = None
                            ) -> torch.Tensor:
    """The plain version: ``out[dst[f]] = x[f]``, i.e. ``x`` indexed by the
    inverse permutation."""
    g = _resolve_geometry(x, geometry)
    dst = _dst_table(perm, g)
    src = [0] * g.total
    for f, d in enumerate(dst):
        src[d] = f
    return x[torch.tensor(src, device=x.device)]


def fused_permute(x: torch.Tensor, perm, *,
                  geometry: RingGeometry | None = None) -> torch.Tensor:
    """A permutation of ranks with the copies issued by the device: rank
    ``s``'s row lands on rank ``d`` for every ``(s, d)`` in ``perm`` (ring
    positions under ``geometry``). The pair list must be a full
    permutation (:func:`ring.check_permutation`): every rank waits on
    exactly one incoming copy. Any dtype. CUDA: the kernel. CPU:
    :func:`fused_permute_reference`."""
    g = _resolve_geometry(x, geometry)
    dst = _dst_table(perm, g)
    if x.device.type == "cpu" or g.size == 1:
        return fused_permute_reference(x, perm, geometry=g)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _lib()
    _raise_on_status(lib)
    x = x.contiguous()
    row_bytes = x[0].numel() * x.element_size()
    G = _grid("fused_permute", 0, g.total,
              -(-row_bytes // (16 * 4 * _THREADS)))

    def make():
        return {"dst": torch.tensor(dst, dtype=torch.int32, device=x.device),
                "counters": torch.zeros(g.total, dtype=torch.int32,
                                        device=x.device),
                "abort": torch.zeros(1, dtype=torch.int32, device=x.device)}

    s = _get_scratch(("permute", x.device, tuple(dst), G), make)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.fused_permute(
            x.data_ptr(), out.data_ptr(), s["dst"].data_ptr(),
            s["counters"].data_ptr(), s["abort"].data_ptr(), s["epoch"],
            g.total, row_bytes, G, SPIN_TIMEOUT_NS, stream)
    _build.check(rc, "fused_permute")
    launches["fused_permute"] += 1
    return out


def fused_ring_shift(x: torch.Tensor, shift: int = 1, *,
                     geometry: RingGeometry | None = None) -> torch.Tensor:
    """Device-initiated :func:`ring.ring_shift`: rank r's row lands on rank
    ``(r + shift) % size``."""
    size = geometry.size if geometry is not None else x.shape[0]
    return fused_permute(x, ring._ring_perm(size, shift), geometry=geometry)
