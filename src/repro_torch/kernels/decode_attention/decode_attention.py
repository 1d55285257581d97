"""Paged single-token decode attention: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

One query token per sequence attends over a KV history stored as fixed-size
pages whose physical slots the Timestamp-Aware Cache assigned
(``repro_torch.serving.arena``).  ``page_table [B, P]`` names each
sequence's pages in order; positions at or past ``seq_lens[b]`` are masked
and their pages are never read, so their table entries may be -1 (a probe
miss).  One KV head is shared by all H query heads; callers with
grouped-query attention fold the KV heads into the batch
(q ``[B * KV, H / KV, d]``, one table row per sequence and KV head).

Keys are d wide and values dv wide (``v_pages [n_slots, page, dv]``):
a paged MLA latent cache has d 576 and dv 512.

``paged_decode_attention_kernel`` launches the kernel for CUDA tensors and
runs ``paged_decode_plain`` for CPU tensors; it never falls back from one to
the other.  On the card a launch cuts each row's page table into
``plan_splits`` contiguous ranges, one block each, and a second kernel
merges the ranges' partial softmax states.  ``instance`` picks the built
instance (route, DK, DV) that runs (d, dv) in a type at H query heads a
row: float32 at d = dv in ``HEAD_DIMS`` on its own instance; bfloat16
rows of whole 16-byte chunks on the tensor cores up to (256, 256) (up to
128 in registers, (256, 256) with Q in shared memory), and past 256 up
to (``LANES_D``, ``LANES_DV``), MLA's latent, on wgmma ("wgmma": 64
heads a block, Q resident in 128-byte-swizzle boxes, K and V copied by
cp.async through a ring of 8 KB boxes that holds a tile, ``wg_plan``);
every other width up to (``LANES_D``, ``LANES_DV``) at more than
``LANES_HEADS`` heads on the TF32 walk below, at fewer on the CUDA
cores, a warp a token, the widths in registers ("lanes", which reads
each K and V byte once a ``LANES_HEADS`` heads); any wider key or value
width in bfloat16 with rows of whole 16-byte chunks on the tensor cores
("walk_tc": 16 heads a block, K and V walked in tiles of tokens and
chunks of columns through a shared-memory ring, value columns in groups
of ``WALK_TC_COLS``, ``walk_tc_plan``); in float32 or at bfloat16 rows
of other widths on the same plan in TF32 ("walk": float32 as three
products of operands split hi + lo, bfloat16 as one; rows of any
alignment copied as the 16-byte windows that cover them,
``walk_windows``; ``walk_plan``).  Every route reads the pool in place
at its own widths; only q is zero-padded to DK on the tensor cores'
instances.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_build

# launches of the CUDA kernel (not of the plain version) since the last reset
LAUNCHES = 0

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)     # square instances (one build a type each)
WIDE = 256                        # the bf16 tensor-core instance past 128
LANES_D, LANES_DV = 576, 512      # the lanes instance; wider: the walks
LANES_HEADS = 4                   # heads a lanes block; more: the TF32 walk
ROUTES = {"workers": 0, "tensor_cores": 1, "lanes": 2, "walk": 3,
          "walk_tc": 4, "wgmma": 5}
# the wgmma route (route 5): query heads and tokens a block's tile, 8 KB
# boxes of 64 x 64 bf16, and the stages of its ring at most
WG_HEADS, WG_TILE, WG_BOX_BYTES, WG_MAX_STAGES = 64, 64, 8192, 24
# the tensor-core walk (csrc/decode_attention.cu, route 4): tokens a tile,
# columns a ring entry, entries of the ring, value columns a block, query
# heads a block, and an H100 block's most shared memory
WALK_TC_TILE, WALK_TC_CHUNK, WALK_TC_STAGES = 64, 64, 8
WALK_TC_COLS, WALK_TC_HEADS, SMEM_LIMIT = 1024, 16, 232448
# the TF32 walk (route 3) on the tensor-core walk's tiles, chunks, value
# columns a block and heads a block: by type, the ring's entries and the
# shared row pitches (elements) of its K and V entries; the shared memory
# of a block when two share an SM (half of its 233,472 bytes less the
# 1,024 each block reserves)
WALK_STAGES = {torch.float32: 4, torch.bfloat16: 8}
WALK_PITCHES = {torch.float32: (68, 72), torch.bfloat16: (72, 80)}
WALK_BLOCK_SMEM = 115712
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_WAVE_SHARE = 0.9            # least share of the last wave kept busy
_PLANS = {}                       # (instance, H > 4, dtype) -> launch_plan


def instance(d: int, dv: int, dtype, H: int = 1) -> tuple:
    """The built instance (route, DK, DV) that runs key width ``d`` and
    value width ``dv`` in ``dtype`` at ``H`` query heads a row: "workers"
    for float32 at d = dv in ``HEAD_DIMS`` (the instance as it was first
    built); for bfloat16 whose rows are whole 16-byte chunks (d, dv
    multiples of 8) "tensor_cores" up to (``WIDE``, ``WIDE``), at the
    smallest square of ``HEAD_DIMS`` and ``WIDE`` that holds both, and
    "wgmma" at the caller's (d, dv) past it up to (``LANES_D``,
    ``LANES_DV``); every other width up to those "lanes", one instance at
    them, at ``LANES_HEADS`` heads or fewer, and "walk" at the caller's
    (d, dv) past that head count; past (``LANES_D``, ``LANES_DV``), at the
    caller's (d, dv), "walk_tc" for bfloat16 rows of whole 16-byte chunks
    and "walk" for the rest.  Raises for a width below 1."""
    if d < 1 or dv < 1:
        raise ValueError(f"decode_attention: key and value widths >= 1, "
                         f"not d={d}, dv={dv}")
    whole = dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
    if d > LANES_D or dv > LANES_DV:
        return ("walk_tc" if whole else "walk", d, dv)
    if dtype == torch.float32 and d == dv and d in HEAD_DIMS:
        return ("workers", d, d)
    if whole:
        if d > WIDE or dv > WIDE:
            return ("wgmma", d, dv)
        n = next(n for n in HEAD_DIMS + (WIDE,) if d <= n and dv <= n)
        return ("tensor_cores", n, n)
    if H > LANES_HEADS:
        return ("walk", d, dv)
    return ("lanes", LANES_D, LANES_DV)


class WgPlan(NamedTuple):
    """The wgmma route's blocks at (d, dv) (``WgPlan`` in the source): a
    block takes ``heads`` query heads and tiles of ``tile`` tokens; Q's
    ``k_boxes`` boxes of 64 columns stay resident (``q_resident``) beside
    one ring of ``stages`` 8 KB boxes, a tile ``k_boxes`` of K, then
    ``v_boxes`` of V; the block's shared memory."""
    heads: int
    tile: int
    k_boxes: int
    v_boxes: int
    q_resident: bool
    stages: int
    smem_bytes: int

    def reads(self, d: int, dv: int, H: int, tokens: int):
        """(K bytes, V bytes) the launch asks the pool for at ``tokens``
        positions of H query heads: each (row, block of ``heads`` heads)
        asks for K and V once."""
        blocks = -(-H // self.heads)
        return 2 * tokens * d * blocks, 2 * tokens * dv * blocks


def wg_plan(d: int, dv: int) -> WgPlan:
    """The wgmma route's plan at (d, dv), as ``wg_plan`` in the source
    computes it: 1,536 bytes of alignment slack and mbarriers and Q's
    boxes, then as many 8 KB stages as fit in ``SMEM_LIMIT``, at most
    ``WG_MAX_STAGES`` (up to (576, 512) at least a tile's boxes)."""
    k_boxes, v_boxes = -(-d // 64), -(-dv // 64)
    fixed = 1536 + k_boxes * WG_BOX_BYTES
    stages = min((SMEM_LIMIT - fixed) // WG_BOX_BYTES, WG_MAX_STAGES)
    return WgPlan(WG_HEADS, WG_TILE, k_boxes, v_boxes, True, stages,
                  fixed + stages * WG_BOX_BYTES)


def wg_source_plan(d: int, dv: int) -> WgPlan:
    """The wgmma route's plan as the built source computes it, in
    ``wg_plan``'s fields."""
    fn = cuda_build.load("decode_attention").decode_wg_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 7)()
    fn(d, dv, ctypes.addressof(out))
    f = list(out)
    return WgPlan(*f[:4], bool(f[4]), *f[5:])


class WalkTcPlan(NamedTuple):
    """The tensor-core walk's blocks at (d, dv) (``WalkTcPlan`` in the
    source): a tile of ``tile`` tokens walks d in ``k_chunks`` ring
    entries of ``chunk`` columns, then its group's value columns in
    ``v_chunks``; ``groups`` blocks of at most ``group_cols`` value
    columns each (each recomputes the scores); Q resident in shared memory
    or, past what fits beside the ring, 16 more rows of each K entry
    (``entry_rows``); ``stages`` entries in the ring; the block's shared
    memory."""
    tile: int
    chunk: int
    k_chunks: int
    groups: int
    group_cols: int
    v_chunks: int
    q_resident: bool
    entry_rows: int
    stages: int
    smem_bytes: int

    def reads(self, d: int, dv: int, H: int, tokens: int):
        """(K bytes, V bytes) the launch reads from the pool for
        ``tokens`` positions of H query heads: each (row, head chunk)
        reads V once and K once a group."""
        chunks = -(-H // WALK_TC_HEADS)
        return (2 * tokens * d * chunks * self.groups,
                2 * tokens * dv * chunks)


def walk_tc_plan(d: int, dv: int) -> WalkTcPlan:
    """The tensor-core walk's plan at (d, dv), as ``walk_tc_plan`` in the
    source computes it: the ring (``WALK_TC_STAGES`` entries of tokens x
    (chunk + 8) bf16), then Q [16, k_chunks x chunk + 8] bf16 where all
    of it fits within ``SMEM_LIMIT``, then P [16, chunk + 8] bf16 and the
    warps' maxima [8, 16] fp32."""
    k_chunks = -(-d // WALK_TC_CHUNK)
    groups = -(-dv // WALK_TC_COLS)
    group_cols = min(dv, WALK_TC_COLS)
    pitch = WALK_TC_CHUNK + 8
    fixed = WALK_TC_HEADS * pitch * 2 + 8 * WALK_TC_HEADS * 4
    q_bytes = WALK_TC_HEADS * (k_chunks * WALK_TC_CHUNK + 8) * 2
    ring = WALK_TC_STAGES * WALK_TC_TILE * pitch * 2
    resident = fixed + q_bytes + ring <= SMEM_LIMIT
    rows = WALK_TC_TILE + (0 if resident else WALK_TC_HEADS)
    return WalkTcPlan(WALK_TC_TILE, WALK_TC_CHUNK, k_chunks, groups,
                      group_cols, -(-group_cols // WALK_TC_CHUNK), resident,
                      rows, WALK_TC_STAGES,
                      fixed + (q_bytes if resident else 0)
                      + WALK_TC_STAGES * rows * pitch * 2)


def walk_tc_source_plan(d: int, dv: int) -> WalkTcPlan:
    """The tensor-core walk's plan as the built source computes it, in
    ``walk_tc_plan``'s fields."""
    fn = cuda_build.load("decode_attention").decode_walk_tc_plan
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 10)()
    fn(d, dv, ctypes.addressof(out))
    f = list(out)
    return WalkTcPlan(*f[:6], bool(f[6]), *f[7:])


class WalkPlan(NamedTuple):
    """The TF32 walk's blocks at (d, dv) in a type (``WalkPlan`` in the
    source): tiles of ``tile`` tokens walk d in ``k_chunks`` ring entries
    of ``chunk`` columns, then the group's value columns in ``v_chunks``;
    ``groups`` blocks of at most ``group_cols`` value columns (each
    recomputes the scores); a row chunk is copied as 16-byte windows of
    ``window`` elements into a shared row of ``k_pitch`` (K) or
    ``v_pitch`` (V) elements; Q resident in shared memory, rows of
    ``q_pitch``, or, past what fits beside the ring, 16 more rows of each
    K entry (``entry_rows``); ``stages`` entries in the ring; the tiles'
    row shifts in ``shift_tiles`` slots, enough for every tile the copier
    can enter while a tile's shifts are still to be read; the block's
    shared memory."""
    tile: int
    chunk: int
    window: int
    stages: int
    k_chunks: int
    groups: int
    group_cols: int
    v_chunks: int
    q_resident: bool
    entry_rows: int
    k_pitch: int
    v_pitch: int
    q_pitch: int
    shift_tiles: int
    smem_bytes: int

    def reads(self, d: int, dv: int, H: int, tokens: int):
        """(K bytes, V bytes) of the rows the launch asks for at
        ``tokens`` positions of H query heads: each (row, head chunk)
        asks for V once and K once a group (the windows of rows that are
        not whole 16-byte chunks read more: ``walk_windows``)."""
        chunks = -(-H // WALK_TC_HEADS)
        item = 16 // self.window
        return (item * tokens * d * chunks * self.groups,
                item * tokens * dv * chunks)


def walk_plan(d: int, dv: int, dtype) -> WalkPlan:
    """The TF32 walk's plan at (d, dv) in ``dtype``, as ``walk_plan`` in the
    source computes it: the ring (``WALK_STAGES`` entries of tokens x the
    wider of the two pitches), then Q [16, q_pitch] of the type where all
    of it fits within ``WALK_BLOCK_SMEM`` (two blocks an SM), then P's A
    fragments, TF32 hi and lo [tile / 8, 32, 4] uint32, the warps' maxima
    [8, 16] fp32 and the tiles' shifts [shift_tiles, 2, tile] bytes.  The
    copier runs stages - 1 entries ahead and writes a tile's shifts as it
    enters it, and a tile's are read up to its K entries' end, so with
    tiles of k_chunks + v_chunks entries (fewest in the last group) it can
    enter (stages - 1 + k_chunks) // that more tiles first, each into a
    slot of its own: one slot where that is none, else stages // 2 + 1,
    the most it can be (tiles of two entries)."""
    item = torch.empty((), dtype=dtype).element_size()
    window = 16 // item
    stages = WALK_STAGES[dtype]
    k_pitch, v_pitch = WALK_PITCHES[dtype]
    k_chunks = -(-d // WALK_TC_CHUNK)
    groups = -(-dv // WALK_TC_COLS)
    group_cols = min(dv, WALK_TC_COLS)
    q_pitch = k_chunks * WALK_TC_CHUNK + window
    row = max(k_pitch, v_pitch)
    fewest = k_chunks + -(-(dv - (groups - 1) * WALK_TC_COLS)
                          // WALK_TC_CHUNK)
    shift_tiles = stages // 2 + 1 if (stages - 1 + k_chunks) // fewest \
        else 1
    fixed = 2 * WALK_TC_TILE // 8 * 32 * 4 * 4 + 8 * WALK_TC_HEADS * 4 \
        + 2 * WALK_TC_TILE * shift_tiles
    q_bytes = WALK_TC_HEADS * q_pitch * item
    resident = fixed + q_bytes + stages * WALK_TC_TILE * row * item \
        <= WALK_BLOCK_SMEM
    rows = WALK_TC_TILE + (0 if resident else WALK_TC_HEADS)
    return WalkPlan(WALK_TC_TILE, WALK_TC_CHUNK, window, stages, k_chunks,
                    groups, group_cols, -(-group_cols // WALK_TC_CHUNK),
                    resident, rows, k_pitch, v_pitch, q_pitch, shift_tiles,
                    fixed + (q_bytes if resident else 0)
                    + stages * rows * row * item)


def walk_source_plan(d: int, dv: int, dtype) -> WalkPlan:
    """The TF32 walk's plan as the built source computes it, in
    ``walk_plan``'s fields."""
    fn = cuda_build.load("decode_attention").decode_walk_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = None
    out = (ctypes.c_int * 15)()
    fn(d, dv, _DTYPES[dtype], ctypes.addressof(out))
    f = list(out)
    return WalkPlan(*f[:8], bool(f[8]), *f[9:])


def walk_windows(e0, col0: int, n: int, item: int, total: int):
    """The 16-byte windows the TF32 walk copies for columns col0 .. col0 +
    n - 1 (col0 a multiple of the window) of pool rows that start at
    elements ``e0`` (a tensor; -1 for a row it zero-fills) of a pool of
    ``total`` elements of ``item`` bytes, as ``copy_windows`` in the
    source: for each row the first element of its first window (the
    boundary at or below the chunk's first element; -1 where nothing is
    read), its number of windows, and the bytes they read, every window 16
    but at the pool's last bytes, where one reads what remains and
    cp.async zero-fills the rest.  ``walk_source_windows`` gives the
    source's."""
    window = 16 // item
    e0 = e0.long()
    row = e0 >= 0
    sh = torch.where(row, e0 % window, 0)
    base = torch.where(row, e0 - sh + col0, -1)
    nwin = torch.where(row, (sh + n + window - 1) // window,
                       WALK_TC_CHUNK // window + 1)
    left = torch.where(row, torch.clamp(total - (e0 - sh), max=1 << 28), 0) \
        - col0
    nbytes = torch.minimum(nwin * window, left).clamp(min=0) * item
    return base, nwin, nbytes


def walk_source_windows(e0, col0: int, n: int, item: int, total: int):
    """``walk_windows`` as the built source computes it
    (``decode_walk_windows``), in its fields."""
    fn = cuda_build.load("decode_attention").decode_walk_windows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int] \
        + [ctypes.c_void_p] * 3
    fn.restype = None
    rows = e0.long().cpu().contiguous()
    count = rows.numel()
    base = torch.empty(count, dtype=torch.int64)
    nwin = torch.empty(count, dtype=torch.int32)
    nbytes = torch.empty(count, dtype=torch.int32)
    fn(rows.data_ptr(), count, col0, n, total, int(item == 2),
       base.data_ptr(), nwin.data_ptr(), nbytes.data_ptr())
    return base, nwin.long(), nbytes.long()


def plan_splits(units: int, pages: int, sms: int, per_sm: int = 1,
                busy: float = 1.0) -> int:
    """How many contiguous page ranges (splits) each of ``units`` (row,
    head chunk) blocks is cut into, for ``pages`` table columns on a card
    of ``sms`` SMs that holds ``per_sm`` blocks of pass 1 each.  When every
    page as its own block is still less than one wave, every page gets one
    (the card fills as far as the work allows); otherwise the fewest splits
    that give a block to every SM (at least ``busy`` of them, where a
    split's partials cost more than an idle SM) and leave the last wave at
    least ``SPLIT_WAVE_SHARE`` full, or failing that the best-filled count.
    Always in [1, pages]; 1 for a single page."""
    if units <= 0 or pages <= 1:
        return 1
    slots = sms * max(per_sm, 1)
    if units * pages <= slots:
        return pages
    best, best_share = 1, 0.0
    for n in range(1, pages + 1):
        if -(-pages // -(-pages // n)) != n:
            continue            # ranges of ceil(pages / n) leave one empty
        blocks = units * n
        share = blocks / (-(-blocks // slots) * slots)
        if share >= SPLIT_WAVE_SHARE and blocks >= busy * sms:
            return n
        if share > best_share:
            best, best_share = n, share
    return best


def _needed(page_table, seq_lens, page: int) -> torch.Tensor:
    """[B, P] bool: the pages that hold a position below ``seq_len``."""
    P = page_table.shape[1]
    first = torch.arange(P, device=page_table.device) * page
    return first[None, :] < seq_lens[:, None].long()


def paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens):
    """The Pallas kernel's function in plain PyTorch: fp32 scores divided by
    sqrt(d), masked to -1e30 at or past ``seq_len``, softmax in fp32 and
    ``acc / max(l, 1e-30)`` (a sequence of length 0 gives zeros).  Pages
    past ``seq_len`` are not read."""
    B, H, d = q.shape
    page = k_pages.shape[1]
    P = page_table.shape[1]
    T = P * page
    tbl = torch.where(_needed(page_table, seq_lens, page), page_table,
                      0).long()
    k = k_pages[tbl].reshape(B, T, -1).float()
    v = v_pages[tbl].reshape(B, T, -1).float()
    valid = (torch.arange(T, device=q.device)[None, :]
             < seq_lens[:, None].long())[:, None, :]            # [B, 1, T]
    s = torch.einsum("bhd,btd->bht", q.float(), k) / math.sqrt(d)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    out = torch.einsum("bht,btd->bhd", p, v) \
        / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, seq_lens) -> None:
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention: all tensors must be on one "
                         "device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("decode_attention: page_table and seq_lens must be "
                        "int32")
    if q.dim() != 3 or k_pages.dim() != 3 or v_pages.dim() != 3 \
            or page_table.dim() != 2 or seq_lens.shape != (q.shape[0],) \
            or page_table.shape[0] != q.shape[0] \
            or k_pages.shape[:2] != v_pages.shape[:2] \
            or k_pages.shape[2] != q.shape[2]:
        raise ValueError("decode_attention: shapes q [B, H, d], pages "
                         "[n_slots, page, d*], page_table [B, P], seq_lens "
                         "[B] expected")


def _check_range(page_table, seq_lens, n_slots: int, page: int) -> None:
    bad = _needed(page_table, seq_lens, page) \
        & ((page_table < 0) | (page_table >= n_slots))
    if bool(bad.any()):
        raise IndexError(f"decode_attention: a page below seq_len names a "
                         f"slot outside [0, {n_slots})")


def launch_plan(d: int, dv: int, H: int, dtype, inst=None):
    """(query heads a pass-1 block takes, such blocks an SM holds at once)
    for the instance that runs (d, dv) in this type (or ``inst``), at this
    head count, as the library reports them (asked once each)."""
    inst = inst or instance(d, dv, dtype, H)
    key = (inst, H > 4, dtype)
    if key not in _PLANS:
        fn = cuda_build.load("decode_attention").decode_attention_plan
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        heads, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        cuda_build.check(fn(ROUTES[inst[0]], inst[1], inst[2], H,
                            _DTYPES[dtype], ctypes.byref(heads),
                            ctypes.byref(per_sm)), "decode_attention plan")
        _PLANS[key] = (heads.value, per_sm.value)
    return _PLANS[key]


def value_groups(inst) -> int:
    """The blocks a (row, head chunk, split) of instance ``inst`` takes:
    the walks' groups of value columns (from their plans; the TF32 walk's
    are the same in both types), else 1."""
    route, d, dv = inst
    if route == "walk":
        return walk_plan(d, dv, torch.float32).groups
    if route == "walk_tc":
        return walk_tc_plan(d, dv).groups
    return 1


def splits_for(q, P: int, dv=None, inst=None) -> int:
    """The split count a launch on ``q`` [B, H, d] (values ``dv`` wide, d
    unless given) over a table of ``P`` pages uses on the instance that
    runs it (or ``inst``): ``plan_splits`` on this card."""
    B, H, d = q.shape
    dv = dv or d
    inst = inst or instance(d, dv, q.dtype, H)
    heads, per_sm = launch_plan(d, dv, H, q.dtype, inst)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    # the wgmma route's blocks write 64 heads' partials, four times a
    # 16-head block's: a few idle SMs cost less than a wave more of them
    return plan_splits(B * -(-H // heads) * value_groups(inst), P, sms,
                       per_sm, SPLIT_WAVE_SHARE if inst[0] == "wgmma"
                       else 1.0)


def attention_in_range(q, k_pages, v_pages, page_table, seq_lens):
    """``paged_decode_attention_kernel`` without the host-side range check
    (which synchronises), for callers whose table holds only slots the
    arena returned for resident pages; the kernel still reads no slot
    outside the pool."""
    _check(q, k_pages, v_pages, page_table, seq_lens)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, page_table, seq_lens)
    return launch_instance(q, k_pages, v_pages, page_table, seq_lens,
                           instance(q.shape[2], v_pages.shape[2], q.dtype,
                                    q.shape[1]))


def launch_instance(q, k_pages, v_pages, page_table, seq_lens, inst):
    """The CUDA kernel's instance ``inst`` (route, DK, DV) on these checked
    CUDA tensors, its launch counted: ``attention_in_range`` names the
    one ``instance`` picks; a comparison of routes at one width names
    another (the TF32 walk beside the tensor-core one).  Raises for
    an instance that does not take these widths."""
    global LAUNCHES
    B, H, d = q.shape
    n_slots, page, dv = v_pages.shape
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"decode_attention: no kernel for q {q.dtype}, "
                        f"pages {k_pages.dtype}/{v_pages.dtype}")
    route, DK, DV = inst
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("decode_attention: q and pages must be 16-byte "
                         "aligned")
    out = torch.empty((B, H, dv), dtype=q.dtype, device=q.device)
    if B == 0 or H == 0:
        return out
    lib = cuda_build.load("decode_attention")
    fn = lib.decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    P = page_table.shape[1]
    n_splits = splits_for(q, P, dv, inst)
    scratch = torch.empty(((dv + 2) * B * H * n_splits,) if n_splits > 1
                          else (0,), dtype=torch.float32, device=q.device)
    if route == "tensor_cores" and d != DK:     # a copy of q, not the pool
        q = torch.nn.functional.pad(q, (0, DK - d))
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
             scratch.data_ptr(), B, H, d, dv, P, page, n_slots, n_splits,
             ROUTES[route], DK, DV, 1.0 / math.sqrt(d), _DTYPES[q.dtype],
             cuda_build.stream_ptr(q.device))
    cuda_build.check(err, "decode_attention")
    LAUNCHES += 1
    return out


def paged_decode_attention_kernel(q, k_pages, v_pages, page_table,
                                  seq_lens):
    """q [B, H, d]; k_pages/v_pages [n_slots, page, d*] (float32 or
    bfloat16, the type of q); page_table [B, P] int32 physical slot ids;
    seq_lens [B] int32.  Returns [B, H, dv] in q's type.  Raises
    ``IndexError`` when a page below ``seq_len`` names a slot outside
    [0, n_slots)."""
    _check(q, k_pages, v_pages, page_table, seq_lens)
    _check_range(page_table, seq_lens, k_pages.shape[0], k_pages.shape[1])
    return attention_in_range(q, k_pages, v_pages, page_table, seq_lens)
