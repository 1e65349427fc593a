"""GLCM sufficient statistics: the CUDA kernel, its wrapper and its plain
PyTorch version.

The kernel (``tpumcia_torch/csrc/glcm_stats.cu``) replaces the TPU kernels
of ``tpumcia/features/pallas_glcm.py`` in the six forms the single-device
extraction runs, each counted on its own in :data:`LAUNCHES_BY_FORM`:

- ``B1a``: ``_kernel`` maskless, ``need_diff=False`` (the fused fast path);
- ``B1b``: ``_kernel`` masked (``has_mask=True``), one offset;
- ``B1c``: ``_kernel`` with ``need_diff=True`` (the difference histogram of
  ``precision='exact'``), masked or not, one offset;
- ``B2``: ``_kernel_multi``, several offsets in one pass (masked or not,
  either ``need_diff``);
- ``B1d``: either of them at H*W >= 65536 or more than 256 levels (up to
  4096), whatever the mask or offset count; always with the difference
  histogram;
- ``B1e``: either of them at more than 4096 levels, up to tpumcia's own bound
  of 32768: the per-level tables no longer fit in a block's shared memory
  whole, so the block builds them in level bands there (16,384 levels a
  band up to 64x64, in the pair table's shared memory once G's walk is
  done), each band filled by a walk of the block's plane and written out
  once with 16-byte streaming stores; no L x L rescale table exists at these
  sizes (256 MB at 8192 levels, 4 GB at 32768): each counted pixel is
  rescaled on its own. Only what cannot stay in shared memory (the pair
  table from 128x128 on, very large planes) lives in a device-memory
  workspace that this wrapper allocates, one slice per block of a
  persistent grid; at 48x48 and 64x64 there is none. Where the (image,
  channel)s are fewer than the resident blocks, several blocks share one.
  Always with the difference histogram.

One thread block reduces one (image, channel) (form B1e: one or, for few
items, several, each taking a share of its bands): shared-memory atomic
histograms for the raw levels, the two marginals and the difference
histogram, and the exact ``sum(G^2)`` limbs of the co-occurrence matrix G;
several offsets reuse the one histogram pass. Every form is bound by the
bytes it moves (:func:`traffic_bytes`; no arithmetic worth counting), and
what keeps a block from that bound is latency, so the kernel spends few
atomics and keeps several blocks on each SM:

- ``sum(G^2)`` comes from the counts G's atomics return (for any per-cell
  f with f(0) = 0, the sum over cells of f(G) is the sum over adds of
  f(old + 1) - f(old)), so G is never scanned;
- G's counts live in an open-addressing table sized to the pairs
  (:func:`pair_table_slots`: 8,192 slots at 48x48 and 64x64), u32 slots
  at <= 256 levels and u64 at the B1d sizes, not in an L x L array; where
  that table would be larger than a dense G, the small sizes keep the
  dense u16 G and the B1d sizes build a u32 G in bands over the occupied
  levels, each band re-walking the pixel pairs and scanned (256x256
  planes);
- where it fits, each block keeps its plane's levels in shared memory as
  u16, so each pixel and mask byte is read from device memory once;
- dynamic shared memory is sized to the layout, and the table layouts run
  256-thread blocks, several per SM (:func:`launch_info` reports them).

The source says more.

:func:`sufficient_stats` and :func:`sufficient_stats_multi` take the plain
version for a CPU tensor and for nothing else. For a CUDA tensor they
launch the kernel or raise: past the kernel's bounds
(:data:`MAX_KERNEL_LEVELS` levels, :data:`MAX_KERNEL_PIXELS` pixels: a count
is carried as f32, exact only below 2^24) they raise a ``ValueError``, while an offset list longer than the kernel's
:data:`MAX_OFFSETS` runs as several launches whose per-offset outputs are
joined. At the B1d and B1e sizes both refuse ``need_diff=False``: the ``dstats``
sums are not exact in f32 there. :data:`LAUNCHES` counts kernel launches
over all forms, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tpumcia_torch.features.stats import (
    SuffStats,
    cheap_limbs,
    MAX_TABLE_LEVELS,
    rescale_lut_device,
    rescale_rows_for,
)

# kernel launches by sufficient_stats*, over all forms and per form; reset
# both with reset_launch_counts() before a run to count its launches
LAUNCHES = 0
LAUNCHES_BY_FORM = {"B1a": 0, "B1b": 0, "B1c": 0, "B2": 0, "B1d": 0, "B1e": 0}

# the kernels' bounds. B1d: its 7L-1 int tables and one band row of L u32
# cells must fit in the 227 KB of shared memory a block may hold; B1e builds
# the tables in level bands up to tpumcia's own level bound (the packed
# wire's, hybrid._quad_shift); every count must stay exact in f32
MAX_SHARED_LEVELS = MAX_TABLE_LEVELS  # 4096: B1d below or at it, B1e above
MAX_KERNEL_LEVELS = 32768
MAX_KERNEL_PIXELS = (1 << 24) - 1  # H*W
MAX_OFFSETS = 16  # the kernel's fixed-size offset argument
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory at 700 W (NVIDIA's data sheet)


def reset_launch_counts() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for form in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[form] = 0


def is_large(hw: int, levels: int) -> bool:
    """True at the B1d sizes: H*W >= 65536 (a u16 G cell could overflow)
    or more than 256 levels."""
    return hw >= 65536 or levels > 256


def past_kernel_bounds(hw: int, levels: int) -> bool:
    """True where no kernel form reaches: a CUDA tensor raises there, a CPU
    tensor takes the plain version as at every size."""
    return levels > MAX_KERNEL_LEVELS or hw > MAX_KERNEL_PIXELS


def kernel_form(*, hw: int, levels: int, masked: bool, need_diff: bool, num_offsets: int) -> str:
    """The name of the kernel form a call runs (see the module doc)."""
    if levels > MAX_SHARED_LEVELS:
        return "B1e"
    if is_large(hw, levels):
        return "B1d"
    if num_offsets > 1:
        return "B2"
    if need_diff:
        return "B1c"
    return "B1b" if masked else "B1a"


def _check_need_diff(hw: int, levels: int, need_diff: bool) -> None:
    if is_large(hw, levels) and not need_diff:
        raise ValueError(
            f"need_diff=False at {hw} pixels and {levels} levels: the dstats "
            "sums are exact in f32 only below 65536 pixels and at <= 256 "
            "levels; ask for the difference histogram (need_diff=True)"
        )


def _window(H: int, W: int, offset) -> tuple[int, int, int, int]:
    dr, dc = offset
    r0, r1 = max(0, -dr), H - max(0, dr)
    c0, c1 = max(0, -dc), W - max(0, dc)
    if r0 >= r1 or c0 >= c1:
        raise ValueError(f"GLCM offset {tuple(offset)} leaves no valid pairs for {H}x{W}")
    return r0, r1, c0, c1


def _pairs(H: int, W: int, offset) -> int:
    r0, r1, c0, c1 = _window(H, W, offset)
    return (r1 - r0) * (c1 - c0)


def pair_table_slots(H: int, W: int, offsets, levels: int) -> int:
    """The slots of the kernel's pair count table for ``offsets`` on HxW
    planes at ``levels``: the smallest power of two that holds twice the
    largest offset's pair window (so the table stays at most half full), or
    0 where that table would be larger than a dense G, whose layout the
    kernel takes then: the packed u16 G below the B1d sizes (4 bytes a slot
    against L*L/2 words), the bands of u32 cells at them (8 bytes a slot
    against L*L cells). Whether the table fits in shared memory is the
    kernel's to check: at the B1d sizes one that does not fit beside the
    per-level tables takes the bands (:func:`launch_info` says which). Form
    B1e always takes the table (in its workspace where shared memory cannot
    hold it): below 2^24 pixels it is never larger than G at those levels."""
    slots = 1 << (2 * max(_pairs(H, W, o) for o in offsets) - 1).bit_length()
    if levels > MAX_SHARED_LEVELS:
        return slots
    if is_large(H * W, levels):
        smaller = 8 * slots <= 4 * levels * levels
    else:
        smaller = 4 * slots <= 4 * ((levels * levels + 1) // 2)
    return slots if smaller else 0


def table_bits(slots: int) -> int:
    """log2 of :func:`pair_table_slots`' count, 0 for the dense or band
    layout: the kernel's ``table_bits`` argument."""
    return slots.bit_length() - 1 if slots else 0


def traffic_bytes(shape, levels: int, offsets, *, mask_channels: int = 0,
                  need_diff: bool = False) -> int:
    """The bytes one launch must move: each input read once (the int32
    levels, the (B, mask_channels, H, W) uint8 mask, and the rows of the
    L x L int32 rescale table it needs: one per (image, channel), at most
    L; form B1e reads no table) and each output written once (hist, count,
    vmax, and per offset both marginals, the difference histogram or dstats,
    the limbs and the pair count). The kernel's bound is this over the
    card's memory rate: no form does arithmetic worth counting. What form
    B1e moves to and from a workspace is not in it
    (:func:`workspace_traffic_bytes`)."""
    B, C, H, W = shape
    L, O, n = levels, len(offsets), B * C
    table_rows = 0 if L > MAX_SHARED_LEVELS else 4 * L * min(n, L)
    read = 4 * n * H * W + B * mask_channels * H * W + table_rows
    once = 4 * n * L + 4 * n + 4 * n  # hist, count, vmax
    per_offset = 4 * n * (2 * L + (2 * L - 1 if need_diff else 4) + 4 + 1)
    return read + once + O * per_offset


def workspace_traffic_bytes(shape, levels: int, offsets, *, table_in_workspace: bool = False,
                            plane_in_workspace: bool = False) -> int:
    """What form B1e moves to and from its workspace, beside its inputs and
    outputs (``table_in_workspace`` and ``plane_in_workspace`` as
    :func:`launch_info` reports them; 0 where both stay in shared memory, as
    at 48x48 and 64x64): per (image, channel) and offset, the pair table's
    8 bytes a slot zeroed once (the atomics that fill it stay in L2 and are
    not counted); per (image, channel), the plane's 2 bytes a pixel written
    raw, rewritten rescaled and read once (the walks' further reads are not
    counted)."""
    B, C, H, W = shape
    n, O = B * C, len(offsets)
    table = 8 * pair_table_slots(H, W, offsets, levels) * O if table_in_workspace else 0
    plane = 3 * 2 * H * W if plane_in_workspace else 0
    return n * (table + plane)


def bound_ms(nbytes: int) -> float:
    """The least time an H100 SXM could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def b1e_layout(*, table_in_smem: bool, plane_in_smem: bool) -> str:
    """The name of a B1e launch's layout: its level bands in shared memory,
    and what lives in the workspace beside them."""
    outside = [name for name, inside in (("table", table_in_smem), ("plane", plane_in_smem))
               if not inside]
    return "level bands" + (f", {' and '.join(outside)} in workspace" if outside else "")


def launch_info(shape, levels: int, offsets, *, masked: bool, need_diff: bool) -> dict:
    """What a kernel launch on a CUDA tensor of ``shape`` would use, as the
    kernel plans it: its layout (``"table"`` with its slots, ``"dense"`` or
    ``"bands"``; form B1e :func:`b1e_layout`), the block size, the dynamic
    shared memory per block, the resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and whether the
    block keeps its plane in shared memory; for form B1e also whether the
    pair table is in shared memory, the persistent grid's blocks, the blocks
    that share one (image, channel), the levels of one band pass and the
    workspace's bytes. Needs the card."""
    from tpumcia_torch import _build

    B, C, H, W = shape
    if levels > MAX_SHARED_LEVELS:
        info = _workspace_info(H, W, levels, masked, offsets, B * C)
        return {"layout": b1e_layout(table_in_smem=info["table_in_smem"],
                                     plane_in_smem=info["plane_in_smem"]),
                "table_slots": pair_table_slots(H, W, offsets, levels), **info}
    info = (ctypes.c_int * 5)()
    _build.check(
        _build.load_library().tpumcia_glcm_launch_info(
            H, W, levels, int(masked), int(need_diff),
            table_bits(pair_table_slots(H, W, offsets, levels)), info),
        "glcm_stats launch info",
    )
    slots = 1 << info[4] if info[4] else 0
    layout = "table" if slots else ("bands" if is_large(H * W, levels) else "dense")
    return {"layout": layout, "table_slots": slots, "threads": info[0],
            "smem_bytes": info[1], "blocks_per_sm": info[2], "plane_in_smem": bool(info[3])}


def _workspace_info(H: int, W: int, levels: int, masked: bool, offsets, items: int) -> dict:
    """How the kernel plans a B1e launch over ``items`` (image, channel)s."""
    from tpumcia_torch import _build

    info = (ctypes.c_longlong * 10)()
    _build.check(
        _build.load_library().tpumcia_glcm_workspace_info(
            H, W, levels, int(masked), table_bits(pair_table_slots(H, W, offsets, levels)),
            len(offsets), items, info),
        "glcm_stats workspace info",
    )
    return {"threads": info[0], "smem_bytes": info[1], "blocks_per_sm": info[2],
            "plane_in_smem": bool(info[3]), "table_in_smem": bool(info[4]),
            "grid_blocks": info[5], "workspace_bytes": info[6], "slice_bytes": info[7],
            "parts": info[8], "band_levels": info[9]}


def sufficient_stats(
    img: torch.Tensor, mask: torch.Tensor | None = None, *, levels: int,
    offset: tuple[int, int], need_diff: bool = False,
) -> SuffStats:
    """(B, C, H, W) int32 levels in [0, levels) -> :class:`SuffStats` at one
    GLCM ``offset`` (dr, dc).

    ``mask``: None, or the (B, 1 or C, H, W) uint8 plane of
    ``stats.prepare_mask`` (nonzero selects a pixel). ``need_diff``: emit
    the difference histogram (``diff_hist``) instead of ``dstats``. A CPU
    tensor takes :func:`sufficient_stats_reference`; a CUDA tensor launches
    the kernel, or raises past its bounds."""
    return sufficient_stats_multi(
        img, mask, levels=levels, offsets=[offset], need_diff=need_diff
    )[0]


def sufficient_stats_multi(
    img: torch.Tensor, mask: torch.Tensor | None = None, *, levels: int,
    offsets, need_diff: bool = False,
) -> tuple[SuffStats, ...]:
    """:func:`sufficient_stats` for several offsets in one pass: one
    :class:`SuffStats` per offset, all sharing one ``hist``, ``count`` and
    ``vmax`` (as the Pallas multi-offset kernel returns them). More than
    :data:`MAX_OFFSETS` offsets run as several kernel launches, each counted;
    the shared fields are the first launch's."""
    offsets = [tuple(o) for o in offsets]
    _check_need_diff(img.shape[-2] * img.shape[-1], levels, need_diff)
    if img.device.type == "cpu":
        return sufficient_stats_multi_reference(
            img, mask, levels=levels, offsets=offsets, need_diff=need_diff
        )
    return _launch_chunked(img, mask, levels, offsets, need_diff)


def _launch_chunked(img, mask, levels, offsets, need_diff) -> tuple[SuffStats, ...]:
    """:func:`_launch` over an offset list of any length: launches of at most
    :data:`MAX_OFFSETS` offsets (the kernel's fixed-size argument), their
    per-offset outputs joined in order. Every launch recomputes the shared
    ``hist``, ``count`` and ``vmax``; the first launch's are kept."""
    if not offsets:
        raise ValueError("sufficient_stats_multi needs at least one offset")
    out: list[SuffStats] = []
    for i in range(0, len(offsets), MAX_OFFSETS):
        part = _launch(img, mask, levels, offsets[i:i + MAX_OFFSETS], need_diff)
        if out:
            first = out[0]
            part = [s._replace(hist=first.hist, count=first.count, vmax=first.vmax) for s in part]
        out.extend(part)
    return tuple(out)


def _launch(img, mask, levels, offsets, need_diff) -> tuple[SuffStats, ...]:
    global LAUNCHES
    if img.device.type != "cuda":
        raise ValueError(f"sufficient_stats takes a CPU or CUDA tensor; got {img.device}")
    if img.dtype != torch.int32 or img.dim() != 4 or not img.is_contiguous():
        raise ValueError(
            "sufficient_stats wants a contiguous (B, C, H, W) int32 tensor; "
            f"got {img.dtype} shape {tuple(img.shape)} "
            f"contiguous={img.is_contiguous()}"
        )
    B, C, H, W = img.shape
    if levels < 1:
        raise ValueError(f"levels must be >= 1; got {levels}")
    if past_kernel_bounds(H * W, levels):
        raise ValueError(
            f"{H}x{W} images at {levels} levels are past the CUDA GLCM kernel: "
            f"at most {MAX_KERNEL_LEVELS} levels (the wire's exact bounds) and "
            f"{MAX_KERNEL_PIXELS} pixels (counts are carried as f32, exact "
            "below 2^24)"
        )
    if not 1 <= len(offsets) <= MAX_OFFSETS:
        raise ValueError(f"the CUDA kernel takes 1..{MAX_OFFSETS} offsets; got {len(offsets)}")
    for off in offsets:
        _window(H, W, off)
    if mask is not None:
        if (
            mask.device != img.device or mask.dtype != torch.uint8
            or mask.dim() != 4 or mask.shape[0] != B
            or mask.shape[1] not in (1, C) or tuple(mask.shape[2:]) != (H, W)
            or not mask.is_contiguous()
        ):
            raise ValueError(
                "the mask must be a contiguous (B, 1 or C, H, W) uint8 tensor on "
                f"{img.device} (stats.prepare_mask); got {mask.dtype} shape "
                f"{tuple(mask.shape)} on {mask.device} for images {tuple(img.shape)}"
            )
    from tpumcia_torch import _build

    dev = img.device
    f32 = torch.float32
    L, O = levels, len(offsets)
    hist = torch.empty((B, C, L), dtype=f32, device=dev)
    count = torch.empty((B, C), dtype=f32, device=dev)
    vmax = torch.empty((B, C), dtype=torch.int32, device=dev)
    marg_l = torch.empty((O, B, C, L), dtype=f32, device=dev)
    marg_r = torch.empty((O, B, C, L), dtype=f32, device=dev)
    dout = torch.empty((O, B, C, 2 * L - 1 if need_diff else 4), dtype=f32, device=dev)
    sumsq = torch.empty((O, B, C, 4), dtype=torch.int32, device=dev)
    pairs = torch.empty((O, B, C), dtype=f32, device=dev)
    flat_offsets = (ctypes.c_int * (2 * O))(*[int(v) for off in offsets for v in off])
    lib = _build.load_library()
    mask_ptr = None if mask is None else mask.data_ptr()
    mask_channels = 1 if mask is None else mask.shape[1]
    bits = table_bits(pair_table_slots(H, W, offsets, L))
    outputs = [t.data_ptr() for t in (hist, count, vmax, marg_l, marg_r, dout, sumsq, pairs)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if L > MAX_SHARED_LEVELS:
            # form B1e: what shared memory cannot hold (the pair table from
            # 128x128 on, very large planes) lives in this workspace, one
            # slice per resident block; none at 48x48 and 64x64
            ws_bytes = _workspace_info(H, W, L, mask is not None, offsets, B * C)["workspace_bytes"]
            workspace = torch.empty(ws_bytes, dtype=torch.uint8, device=dev) if ws_bytes else None
            code = lib.tpumcia_glcm_stats_workspace(
                img.data_ptr(), mask_ptr, mask_channels, B, C, H, W, L, flat_offsets, O, bits,
                None if workspace is None else workspace.data_ptr(), ws_bytes, *outputs, stream,
            )
        else:
            code = lib.tpumcia_glcm_stats(
                img.data_ptr(), mask_ptr, mask_channels, rescale_lut_device(L, dev).data_ptr(),
                B, C, H, W, L, flat_offsets, O, int(need_diff), int(cheap_limbs(H * W, L)), bits,
                *outputs, stream,
            )
    _build.check(code, "glcm_stats kernel launch")
    if B * C:
        LAUNCHES += 1
        form = kernel_form(hw=H * W, levels=L, masked=mask is not None,
                           need_diff=need_diff, num_offsets=O)
        LAUNCHES_BY_FORM[form] += 1
    return tuple(
        SuffStats(
            hist=hist, count=count, vmax=vmax, marg_l=marg_l[o], marg_r=marg_r[o],
            diff_hist=dout[o] if need_diff else None,
            glcm_sumsq=sumsq[o], pair_count=pairs[o],
            dstats=None if need_diff else dout[o],
        )
        for o in range(O)
    )


# --- the plain version -------------------------------------------------------


def _row_bincount(keys: torch.Tensor, size: int, keep: torch.Tensor | None = None) -> torch.Tensor:
    """(n, P) int64 keys in [0, size) -> (n, size) int64 counts per row;
    with ``keep`` ((n, P) bool), only the kept keys are counted."""
    n = keys.shape[0]
    if keep is not None:
        keys, size_in = torch.where(keep, keys, size), size + 1
    else:
        size_in = size
    base = torch.arange(n, device=keys.device)[:, None] * size_in
    counts = torch.bincount((keys + base).reshape(-1), minlength=n * size_in)
    return counts.reshape(n, size_in)[:, :size]


def _prologue(img: torch.Tensor, mask: torch.Tensor | None, L: int):
    """The offset-independent half: hist, count, vmax (as (B, C) fields),
    the rescaled levels (n, H, W) and the flat mask (n, H*W) bool or None."""
    B, C, H, W = img.shape
    n = B * C
    x = img.reshape(n, H * W).to(torch.int64)
    in_range = (x >= 0) & (x < L)
    # a level outside [0, L) is dropped from the histogram and rescales to
    # 0, as the kernel (and a one-hot) treats it
    if mask is None:
        m = None
        counted = in_range
        count = torch.full((n,), float(H * W), device=img.device)
        vmax = x.amax(1)
    else:
        m = (mask != 0).expand(B, C, H, W).reshape(n, H * W)
        counted = in_range & m
        count = counted.sum(1).to(torch.float32)
        vmax = torch.where(m, x, -1).amax(1)
    hist = _row_bincount(x.clamp(0, L - 1), L, keep=counted)
    # above 4096 levels the rows alone, never the L x L table
    row = rescale_rows_for(L, vmax).to(torch.int64)
    resc = torch.where(in_range, torch.gather(row, 1, x.clamp(0, L - 1)), 0)
    shape = (B, C)
    return (
        hist.to(torch.float32).reshape(*shape, L), count.reshape(shape),
        vmax.to(torch.int32).reshape(shape), resc.reshape(n, H, W), m,
    )


def _sumsq_limbs_occupied(left, right, keep, L: int, cheap: bool) -> torch.Tensor:
    """(n, P) int64 pair levels -> (n, 4) int32 limbs of ``sum(G^2)``, the
    values of ``stats.glcm_sumsq_limbs`` over a dense G, from the occupied
    cells alone (at most P a row): every limb is a sum over cells of a
    function that is 0 at a count of 0. The cells come from sorting the pair
    keys, so no L x L array is built at any level count."""
    n = left.shape[0]
    row = torch.arange(n, device=left.device)[:, None]
    key = (row * L + left) * L + right
    key = key.reshape(-1) if keep is None else key[keep]
    cells, g = torch.unique_consecutive(key.sort().values, return_counts=True)
    cell_row = torch.div(cells, L * L, rounding_mode="floor")

    def per_row(v):
        return torch.zeros(n, dtype=torch.int64, device=left.device).index_add_(0, cell_row, v)

    if cheap:
        s2 = per_row(g * g)
        z = torch.zeros_like(s2)
        limbs = [z, z, s2 >> 8, s2 & 255]
    else:
        a, b = g >> 12, g & 4095
        bb = b * b
        limbs = [per_row(a * a), per_row(a * b), per_row(bb >> 8), per_row(bb & 255)]
    return torch.stack(limbs, -1).to(torch.int32)


def _offset_stats(resc, m, offset, *, shape, levels, need_diff, hist, count, vmax):
    """One offset's marginals, limbs, pair count and difference fields."""
    n, H, W = resc.shape
    L = levels
    r0, r1, c0, c1 = _window(H, W, offset)
    dr, dc = offset
    dev = resc.device
    P = (r1 - r0) * (c1 - c0)  # explicit: a slot of a mesh may hold no rows (n = 0)
    left = resc[:, r0:r1, c0:c1].reshape(n, P)
    right = resc[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc].reshape(n, P)
    if m is None:
        keep = None
        pair_count = torch.full(shape, float((r1 - r0) * (c1 - c0)), device=dev)
    else:
        mm = m.reshape(n, H, W)
        keep = (mm[:, r0:r1, c0:c1] & mm[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc]).reshape(n, P)
        pair_count = keep.sum(1).to(torch.float32).reshape(shape)
    marg_l = _row_bincount(left, L, keep)
    marg_r = _row_bincount(right, L, keep)
    dh = _row_bincount(left - right + (L - 1), 2 * L - 1, keep)

    cheap = cheap_limbs(H * W, L)
    sumsq = _sumsq_limbs_occupied(left, right, keep, L, cheap)

    f32 = torch.float32
    if need_diff:
        diff_hist, dstats = dh.to(f32).reshape(*shape, 2 * L - 1), None
    else:
        diff_hist, dstats = None, dstats_from_diff_hist(dh, cheap).reshape(*shape, 4)
    return SuffStats(
        hist=hist, count=count, vmax=vmax,
        marg_l=marg_l.to(f32).reshape(*shape, L),
        marg_r=marg_r.to(f32).reshape(*shape, L),
        diff_hist=diff_hist,
        glcm_sumsq=sumsq.reshape(*shape, 4),
        pair_count=pair_count,
        dstats=dstats,
    )


def sufficient_stats_reference(
    img: torch.Tensor, mask: torch.Tensor | None = None, *, levels: int,
    offset: tuple[int, int], need_diff: bool = False,
) -> SuffStats:
    """The plain PyTorch version of the kernel: the same outputs from
    ``torch.bincount`` on flat keys (masked-out pixels and pairs are not
    counted), with ``sum(G^2)`` from the counts of the sorted pair keys, G's
    occupied cells. It serves CPU tensors and checks the kernel on the
    card."""
    return sufficient_stats_multi_reference(
        img, mask, levels=levels, offsets=[offset], need_diff=need_diff
    )[0]


def sufficient_stats_multi_reference(
    img: torch.Tensor, mask: torch.Tensor | None = None, *, levels: int,
    offsets, need_diff: bool = False,
) -> tuple[SuffStats, ...]:
    """The plain version of :func:`sufficient_stats_multi`: the
    offset-independent prologue once, then each offset in turn; every
    offset's :class:`SuffStats` shares ``hist``, ``count`` and ``vmax``."""
    B, C = img.shape[:2]
    hist, count, vmax, resc, m = _prologue(img, mask, levels)
    return tuple(
        _offset_stats(
            resc, m, tuple(off), shape=(B, C), levels=levels, need_diff=need_diff,
            hist=hist, count=count, vmax=vmax,
        )
        for off in offsets
    )


def dstats_from_diff_hist(dh: torch.Tensor, cheap: bool) -> torch.Tensor:
    """(..., 2L-1) difference-histogram counts -> (..., 4) f32 ``dstats`` in
    the kernel's encoding; integer sums in int64, the homogeneity sum in
    float64, each rounded once to f32."""
    dh = dh.to(torch.int64)
    L = (dh.shape[-1] + 1) // 2
    d = torch.arange(2 * L - 1, device=dh.device) - (L - 1)
    d2 = d * d
    if cheap:
        t = (dh * d2).sum(-1)
        hi, lo = t >> 8, t & 255
    else:
        hi, lo = (dh * (d2 >> 8)).sum(-1), (dh * (d2 & 255)).sum(-1)
    dis = (dh * d.abs()).sum(-1)
    homog = (dh.to(torch.float64) / (1.0 + d2.to(torch.float64))).sum(-1)
    return torch.stack(
        [hi.to(torch.float32), lo.to(torch.float32), dis.to(torch.float32),
         homog.to(torch.float32)], -1
    )
