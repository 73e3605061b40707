"""Single-query (decode-step) attention against the KV cache: the
counterpart of ``hpc_patterns_tpu/ops/flash_decode.py``.

- :func:`flash_decode_attention`: the LINEAR cache (B, Hkv, S_max, D);
  on CUDA tensors the hand-written Hopper kernel ``csrc/flash_decode.cu``
  (replacing ``_decode_kernel``): the live rows split over the sequence
  in the chunks :func:`decode_chunks` plans, each chunk's partial
  softmax merged by lse (one chunk: normalised in place, no merge); on
  CPU tensors its plain version
  :func:`flash_decode_attention_reference`, ``decode_step``'s masked
  softmax;
- :func:`flash_decode_paged`: the PAGED cache through a page table; on
  CUDA tensors ``csrc/paged_decode.cu`` (replacing
  ``_decode_kernel_paged``): the same split, each sequence's rows in the
  fixed chunks :func:`paged_decode_plan` sets (never by the batch, the kv
  heads or the card), a pass-1 CTA past a sequence's fill doing nothing,
  merged by lse; on CPU tensors :func:`flash_decode_paged_reference`, the
  gather-through-the-table masked softmax of
  ``models/decode.py::_paged_attend_gather``.

Both take caches in the compute dtype or one byte per value (int8,
float8_e4m3fn) with per-row f32 dequant scales: (B, Hkv, S_max) for the
linear cache, (n_pool, Hkv, 1, P) for the pools. The kernels fold the
scales into scores and probabilities (JAX's ``_softmax_block``); the
plain versions dequantize first (``k.float() * scale``), as the gather
view does.
"""

from __future__ import annotations

import ctypes

import torch

from hpc_patterns_tpu_torch.ops import _build

_NEG_INF = -1e30

#: kernel launches in this process, per kernel (the main-path witness)
launches = {"paged_decode": 0, "flash_decode": 0}

HEAD_DIMS = (16, 32, 64, 128)
#: dtype codes of the C entry points (``csrc/decode_common.cuh``)
Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
            torch.float8_e4m3fn: 3}
#: ``flash_decode_split``'s C arguments: q, k, v, ks, vs, pos, out, the
#: workspace, n_chunks, chunk, B, H, Hkv, D, S, scale, q code, kv code,
#: stream
_SPLIT_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 7
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
#: ``paged_decode_split``'s C arguments (kernel 7's ``paged_attention``
#: takes the same): q, k_pool, v_pool, ks_pool,
#: vs_pool, table, pos, pos_scalar, out, the workspace, n_chunks, chunk, B,
#: H, Hkv, D, P, pages, n_pool, scale, q code, kv code, stream
_PAGED_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2
               + [ctypes.c_int] * 9
               + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p])
#: one-byte storage dtypes that carry per-row scales
QUANTIZED = (torch.int8, torch.float8_e4m3fn)
#: query rows per kv head the kernels take (their G_MAX)
G_MAX = 8
#: the linear-cache split: a chunk's rows are a multiple of CHUNK_ROWS
#: (and at least that many), and the split aims at CTAS_PER_SM CTAs on
#: each SM. On an H100 at the precision law's shape with 2 kv heads,
#: 64-row chunks (9 a row) beat 16-row ones (33 a row) by about a third,
#: the other dtypes equal (bench_flash.py, PERF.md): past a few CTAs an
#: SM, a chunk's fixed cost (its CTA, its partial's merge) outweighs the
#: parallelism it adds
CHUNK_ROWS = 64
CTAS_PER_SM = 2
#: the paged split's chunk: rows a pass-1 CTA takes, fixed so that a
#: sequence's bits never depend on what it is batched with (the engine's
#: step against a standalone decode); chosen for kernel 6 on an H100 at the
#: serving shape among 64, 128 and 256 rows, the fastest on bf16, int8 and
#: fp8 pools alike (PERF.md); the exact-softmax kernel 7 takes the same
PAGED_CHUNK_ROWS = 128


def decode_chunks(pos: int, rows: int, sms: int) -> tuple[int, int]:
    """The linear-cache kernel's split of the live rows ``[0, pos]`` of
    each of ``rows`` (B * Hkv) cache rows on a card of ``sms`` SMs:
    ``(n_chunks, chunk)``, chunk i holding rows ``[i * chunk, min((i + 1)
    * chunk, pos + 1))``. Enough chunks for :data:`CTAS_PER_SM` CTAs an
    SM, none shorter than :data:`CHUNK_ROWS` but the last, none empty;
    one chunk when ``rows`` alone fills the card or the rows are few."""
    live = pos + 1
    if live < 1 or rows < 1 or sms < 1:
        raise ValueError(f"no rows to split: pos {pos}, rows {rows}, "
                         f"sms {sms}")
    want = -(-CTAS_PER_SM * sms // rows)
    n = max(1, min(want, -(-live // CHUNK_ROWS)))
    chunk = -(-(-(-live // n)) // CHUNK_ROWS) * CHUNK_ROWS
    return -(-live // chunk), chunk


def paged_decode_chunk(P: int) -> int:
    """The paged kernels' (6 and 7) chunk rows for pages of ``P`` rows:
    :data:`PAGED_CHUNK_ROWS`; where a page's rows are a multiple of 64, it
    is halved (down to 64) until it divides the page or is a multiple of
    it, so that no chunk straddles a page; other page sizes take it as it
    is (a chunk then spans a page edge). It depends on nothing else: not
    the batch, the kv heads, the fill or the card."""
    if P < 1:
        raise ValueError(f"no paged chunk for P {P}")
    rows = PAGED_CHUNK_ROWS
    if P % 64 == 0:
        while P % rows and rows % P:
            rows //= 2
    return rows


def paged_decode_plan(pages: int, P: int) -> tuple[int, int]:
    """``(n_chunks, chunk)`` of the paged kernels for a table of ``pages``
    pages of ``P`` rows: chunk i holds rows ``[i * chunk, (i + 1) *
    chunk)`` of every sequence, and n_chunks covers the table's rows
    (``pos`` lives on the card, so the plan takes the largest fill; a
    chunk past a sequence's fill runs no work)."""
    chunk = paged_decode_chunk(P)
    return -(-pages * P // chunk), chunk


_sms: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` viewed as bytes where it is float8 (gathers and scatters
    move float8 values through this view, which every device indexes),
    else ``t`` itself."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def dequant(cache, scale):
    """One-byte cache rows (..., D) and their f32 scales (...,) -> f32
    values, ``cache.float() * scale`` (JAX ``decode.py::_dequant``)."""
    return cache.float() * scale[..., None].float()


def check_scales(cache, k_scale, v_scale) -> bool:
    """The scale guards of JAX ``paged_attention.py:136-160``: scales
    come together, are required for int8/fp8 caches and refused for
    compute-dtype ones. Returns whether the cache is quantized."""
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale_pool and v_scale_pool come together")
    storage_quantized = cache.dtype in QUANTIZED
    if quantized != storage_quantized:
        raise ValueError(
            f"pool dtype {cache.dtype} "
            f"{'needs' if storage_quantized else 'refuses'} per-row "
            "scale pools (kv_cache_dtype and the scale operands must "
            "agree)")
    return quantized


def _check_paged(q, k_pool, v_pool, table, pos):
    B, H, D = q.shape
    n_pool, Hkv, P, Dp = k_pool.shape
    if H % Hkv or v_pool.shape != k_pool.shape or Dp != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if table.ndim != 2 or table.shape[0] != B:
        raise ValueError(f"table rows {tuple(table.shape)} must be "
                         f"(batch={B}, pages)")
    if torch.is_tensor(pos) and pos.ndim == 1 and pos.shape[0] != B:
        raise ValueError(f"ragged pos has {pos.shape[0]} entries for "
                         f"batch {B}")


def _gather_pages(pool, tbl):
    """(n_pool, Hkv, P, X) -> (B, Hkv, pages * P, X) through the table."""
    B, pages = tbl.shape
    _, Hkv, P, X = pool.shape
    g = raw(pool)[tbl].view(pool.dtype)  # (B, pages, Hkv, P, X)
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, pages * P, X)


def _masked_softmax_attend(q, kd, vd, pos, scale):
    """``decode_step``'s gather block: q (B, H, D), kd/vd (B, Hkv, S, D)
    f32, rows past ``pos`` (int, 0-d or (B,)) masked with -1e30. Returns
    (B, H, D) f32."""
    B, H, D = q.shape
    Hkv, S = kd.shape[1], kd.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", qg, kd) * scale
    idx = torch.arange(S, device=q.device)
    p_ = torch.as_tensor(pos, device=q.device)
    visible = idx <= (p_.reshape(-1, 1, 1, 1) if p_.ndim else p_)
    s = torch.where(visible, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, vd).reshape(B, H, D)


def flash_decode_paged_reference(q, k_pool, v_pool, table, pos,
                                 scale: float | None = None, *,
                                 k_scale_pool=None, v_scale_pool=None):
    """Gather each row's pages through the table into a contiguous
    (B, Hkv, pages*P, D) f32 view (dequantized, ``k.float() * scale``,
    for one-byte pools) and take the masked softmax of the one query per
    head — ``_paged_attend_gather``'s math. ``pos``: int, 0-d or (B,)
    int tensor. Returns (B, H, D) f32."""
    _check_paged(q, k_pool, v_pool, table, pos)
    quantized = check_scales(k_pool, k_scale_pool, v_scale_pool)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    tbl = table.long()
    kd = _gather_pages(k_pool, tbl).float()
    vd = _gather_pages(v_pool, tbl).float()
    if quantized:
        kd = kd * _gather_pages(k_scale_pool.transpose(2, 3), tbl).float()
        vd = vd * _gather_pages(v_scale_pool.transpose(2, 3), tbl).float()
    return _masked_softmax_attend(q, kd, vd, pos, scale)


def flash_decode_attention_reference(q, k_cache, v_cache, pos, *,
                                     k_scale=None, v_scale=None,
                                     scale: float | None = None):
    """The linear cache's plain version: ``decode_step``'s gather block
    (JAX ``decode.py:468-491``) — dequantize (``k.float() * scale``) or
    widen the whole cache, masked softmax of the one query per head over
    rows ``[0, pos]``. Returns (B, H, D) f32."""
    _check_linear(q, k_cache, v_cache)
    quantized = check_scales(k_cache, k_scale, v_scale)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if quantized:
        kd, vd = dequant(k_cache, k_scale), dequant(v_cache, v_scale)
    else:
        kd, vd = k_cache.float(), v_cache.float()
    return _masked_softmax_attend(q, kd, vd, pos, scale)


def _check_linear(q, k_cache, v_cache):
    B, H, D = q.shape
    if (k_cache.ndim != 4 or k_cache.shape[0] != B
            or k_cache.shape[3] != D or H % k_cache.shape[1]
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")


def check_kernel_operands(q, caches, scales, others=()):
    """The CUDA wrappers' shared checks: every operand on q's card,
    contiguous and 16-byte aligned; q f32/bf16; caches of one dtype,
    q's own or one byte per value; scales f32; head_dim and group size
    the kernels take. Returns (q code, cache code)."""
    for name, t in (("q", q), *caches, *scales, *others):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    kdt = caches[0][1].dtype
    if (q.dtype not in Q_CODES or any(c.dtype != kdt for _, c in caches)
            or kdt not in KV_CODES
            or (kdt not in QUANTIZED and kdt != q.dtype)):
        raise ValueError(
            "kernel takes f32/bf16 q with caches of q's dtype or of int8/"
            f"float8_e4m3fn, got q {q.dtype}, caches "
            f"{[str(c.dtype) for _, c in caches]}")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    B, H, D = q.shape
    Hkv = caches[0][1].shape[1]
    if D not in HEAD_DIMS or H // Hkv > G_MAX:
        raise ValueError(f"kernel takes D in {HEAD_DIMS} and "
                         f"H/Hkv <= {G_MAX}; got D={D}, H/Hkv={H // Hkv}")
    return Q_CODES[q.dtype], KV_CODES[kdt]


def kernel_pos(pos, q):
    """(device pointer or None, host scalar) of a decode position: a
    (B,) contiguous int32 tensor on q's card, or a host int. A 0-d CUDA
    tensor raises (reading it would force a sync)."""
    if torch.is_tensor(pos) and pos.ndim == 1:
        if pos.device != q.device or pos.dtype != torch.int32 \
                or not pos.is_contiguous():
            raise ValueError("ragged pos must be a contiguous int32 tensor "
                             "on q's device")
        return pos.data_ptr(), 0
    if torch.is_tensor(pos) and pos.device.type == "cuda":
        raise ValueError("a shared position must be a host int (a 0-d "
                         "CUDA tensor would force a sync); pass int(pos) "
                         "or a (B,) tensor")
    return None, int(pos)


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_paged(source, entry, q, k_pool, v_pool, table, pos,
                 k_scale_pool, v_scale_pool, quantized, scale):
    """Check the operands of a paged kernel on q's card and launch C entry
    ``entry`` of ``csrc/<source>.cu`` (kernel 6's ``paged_decode_split``
    or kernel 7's ``paged_attention``: the same C arguments) on the plan
    of :func:`paged_decode_plan`, with an f32 workspace of B * H *
    n_chunks * (D + 2) values when the table holds more than one chunk;
    the host never reads ``pos``. Returns (B, H, D) f32; raises on what
    the kernels do not take and on a refused launch."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, D = q.shape
    n_pool, Hkv, P, _ = k_pool.shape
    pages = table.shape[1]
    scales = ((("k_scale_pool", k_scale_pool),
               ("v_scale_pool", v_scale_pool)) if quantized else ())
    if table.dtype != torch.int32:
        raise ValueError(f"table must be int32, got {table.dtype}")
    qc, kc = check_kernel_operands(
        q, (("k_pool", k_pool), ("v_pool", v_pool)), scales,
        (("table", table),))
    pos_ptr, pos_scalar = kernel_pos(pos, q)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    n_chunks, chunk = paged_decode_plan(pages, P)
    fn = getattr(_build.load(source), entry)
    fn.argtypes = _PAGED_ARGS
    fn.restype = ctypes.c_int
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    part = None if n_chunks == 1 else torch.empty(
        B * H * n_chunks * (D + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                _ptr(k_scale_pool), _ptr(v_scale_pool), table.data_ptr(),
                pos_ptr, pos_scalar, out.data_ptr(), _ptr(part), n_chunks,
                chunk, B, H, Hkv, D, P, pages, n_pool, float(scale), qc, kc,
                stream)
    _build.check(rc, source)
    return out


def flash_decode_paged(q, k_pool, v_pool, table, pos, *,
                       k_scale_pool=None, v_scale_pool=None,
                       scale: float | None = None,
                       pages_per_step: int | None = None):
    """Attention of one new token per sequence against the paged cache.

    ``q`` (B, H, D); pools (n_pool, Hkv, P, D) in the compute dtype, or
    int8/float8_e4m3fn with ``k_scale_pool``/``v_scale_pool``
    (n_pool, Hkv, 1, P) f32; ``table`` (B, pages) int32 page ids;
    ``pos``: a shared position (int or 0-d tensor) or a (B,) int32
    tensor of per-sequence positions — the row at ``pos`` must already
    hold this token's K/V. Returns (B, H, D) f32. ``pages_per_step`` is
    JAX's grid-step knob and is accepted for parity only: the CUDA kernel
    splits each sequence's rows into the chunks of
    :func:`paged_decode_plan` (a CTA each, merged by lse from an f32
    workspace of B * H * n_chunks * (D + 2) values when the table holds
    more than one chunk); the host never reads ``pos``.
    CUDA: the Hopper kernel (f32/bf16 q; pools of q's dtype or one-byte;
    D in (16, 32, 64, 128); H / Hkv <= :data:`G_MAX`); anything else
    raises. CPU: :func:`flash_decode_paged_reference`."""
    del pages_per_step
    _check_paged(q, k_pool, v_pool, table, pos)
    quantized = check_scales(k_pool, k_scale_pool, v_scale_pool)
    if q.device.type == "cpu":
        return flash_decode_paged_reference(
            q, k_pool, v_pool, table, pos, scale,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool)
    out = launch_paged("paged_decode", "paged_decode_split", q, k_pool,
                       v_pool, table, pos, k_scale_pool, v_scale_pool,
                       quantized, scale)
    launches["paged_decode"] += 1
    return out


def flash_decode_attention(q, k_cache, v_cache, pos, *, k_scale=None,
                           v_scale=None, scale: float | None = None):
    """Attention of one new token per sequence against the LINEAR cache.

    ``q`` (B, H, D); ``k_cache``/``v_cache`` (B, Hkv, S_max, D) in the
    compute dtype, or int8/float8_e4m3fn with ``k_scale``/``v_scale``
    (B, Hkv, S_max) f32; ``pos``: the shared position being decoded (a
    host int or 0-d CPU tensor; the row at ``pos`` must already hold this
    token's K/V). Returns (B, H, D) f32. The CUDA kernel streams rows
    ``[0, pos]`` in the chunks of :func:`decode_chunks` (JAX's
    ``block_s`` has no counterpart), each chunk a CTA per (sequence, kv
    head), then merges the chunks' partial softmaxes by lse from an f32
    workspace of B * H * n_chunks * (D + 2) values; one chunk normalises
    its rows in place and takes no workspace.
    CUDA: the Hopper kernel (the dtypes, D and group sizes of
    :func:`flash_decode_paged`); anything else raises. CPU:
    :func:`flash_decode_attention_reference`."""
    _check_linear(q, k_cache, v_cache)
    quantized = check_scales(k_cache, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_attention_reference(
            q, k_cache, v_cache, pos, k_scale=k_scale, v_scale=v_scale,
            scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_tensor(pos) and pos.ndim:
        raise ValueError("the linear cache takes one shared position")
    B, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if quantized \
        else ()
    qc, kc = check_kernel_operands(
        q, (("k_cache", k_cache), ("v_cache", v_cache)), scales)
    _, pos_scalar = kernel_pos(pos, q)
    if not 0 <= pos_scalar < S:
        raise ValueError(f"pos {pos_scalar} outside the cache [0, {S})")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    n_chunks, chunk = decode_chunks(pos_scalar, B * Hkv,
                                    _sm_count(q.device))
    out = torch.empty((B, H, D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = None if n_chunks == 1 else torch.empty(
        B * H * n_chunks * (D + 2), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_decode").flash_decode_split
    fn.argtypes = _SPLIT_ARGS
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                _ptr(k_scale), _ptr(v_scale), pos_scalar, out.data_ptr(),
                _ptr(part), n_chunks, chunk, B, H, Hkv, D, S, float(scale),
                qc, kc, stream)
    _build.check(rc, "flash_decode")
    launches["flash_decode"] += 1
    return out

