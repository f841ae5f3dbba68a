"""Impl dispatch, the length-bucketed paged-dispatch planner and the
bit-plane ops.

Counterpart of `repro.kernels.ops`. The planner
half (`make_bucket_plan`, `plan_streamed_pages`,
`grouped_streamed_pages`, `is_bucket_plan`) is pure numpy and gives the
reference's `(plan, perm)` exactly; `bucket_args*` add the
serving-layer gate and move the permutations onto the launch device.

`quantize_and_pack`, `bitplane_matmul`, `bitplane_grouped_matmul` (K6,
a stacked expert weight over expert-sorted rows) and `packed_bytes` are
the bit-plane half (the reference's lines 250-314): K5 packs at load, K3
(B <= 512 rows) or K4 (above) computes the raw contraction, and
`bitplane_matmul` applies the offset and the per-channel scale. It is
also the dispatch point that reports K3/K4's work (`kernels.work`).

Impl names belong to the port:

    auto  the CUDA kernel for CUDA tensors, the plain PyTorch version
          for CPU tensors — decided by where the data lies, never by a
          fallback after a failed build or launch
    cuda  strict: the CUDA kernel, raising on CPU tensors
    ref   the plain PyTorch version, wherever the tensors lie
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np
import torch

from . import ref, work
from .bitplane_gemm import bitplane_gemm
from .bitplane_gemv import bitplane_gemv
from .bitplane_grouped import bitplane_grouped
from .pack import pack_bitplanes

Impl = Literal["auto", "cuda", "ref"]

#: a bucket plan: ((walk_depth, padded_slot_count), ...) — hashable, so
#: it can key the step cache of `serve.compiled`
BucketPlan = Tuple[Tuple[int, int], ...]
BucketStrategy = Literal["none", "pow2"]

#: B threshold below which the GEMV (untiled-B) kernel is used
_GEMV_MAX_B = 512


def resolve_impl(impl: str, device) -> Literal["ref", "cuda"]:
    """Single home of the impl-dispatch rule: which path a launch on
    tensors living on `device` takes. `auto` follows the device;
    explicit values are strict (`cuda` on a CPU device raises — a run
    that asks for the kernel must never measure the plain version)."""
    dev = torch.device(device)
    if impl == "ref":
        return "ref"
    if impl == "auto":
        return "cuda" if dev.type == "cuda" else "ref"
    if impl == "cuda":
        if dev.type != "cuda":
            raise RuntimeError(
                f"impl='cuda' requests the CUDA kernel but the tensors lie "
                f"on {dev}; use impl='ref' for the plain version or "
                "impl='auto' to follow the device"
            )
        return "cuda"
    raise ValueError(
        f"unknown impl {impl!r}; expected one of 'auto', 'cuda', 'ref'"
    )


def resolve_bucket_strategy(strategy: str) -> BucketStrategy:
    """`"none"` keeps the single full-depth launch, `"pow2"` groups slots
    into power-of-two occupancy buckets so no launch walks a page beyond
    its bucket bound."""
    if strategy in ("none", "pow2"):
        return strategy
    raise ValueError(
        f"unknown bucket_strategy {strategy!r}; expected 'none' or 'pow2'"
    )


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def make_bucket_plan(
    lengths,
    block_size: int,
    table_width: int,
    strategy: str = "pow2",
    needs=None,
) -> Tuple[Optional[BucketPlan], Optional[np.ndarray]]:
    """Host-side slot→bucket packing for one paged-kernel dispatch.

    Each slot needs `ceil(len / block_size)` table entries walked (or
    `needs[slot]` when given — windowed layers count live trailing
    blocks only). Slots are grouped by that need rounded up to a power
    of two (clipped to `table_width`), and each group's slot count is
    padded to a power of two, which bounds the set of launch shapes.

    Returns `(plan, perm)`: `plan` is `((bound, padded_count), ...)`
    sorted by bound, `perm` the int32 slot ids grouped by bucket with
    padding entries equal to `n_slots` (they gather a dummy row whose
    output is dropped). `(None, None)` means single launch: strategy
    `"none"`, no slots, or a plan that would walk at least as many
    entries as the single full-depth launch."""
    if resolve_bucket_strategy(strategy) == "none":
        return None, None
    if needs is None:
        lens = np.asarray(lengths).reshape(-1)
        need = -(-np.maximum(lens.astype(np.int64), 1) // block_size)
    else:
        need = np.maximum(np.asarray(needs).reshape(-1).astype(np.int64), 1)
    n = int(need.shape[0])
    if n == 0:
        return None, None
    buckets: dict = {}
    for slot, nd in enumerate(need):
        bound = min(_next_pow2(int(nd)), table_width)
        buckets.setdefault(bound, []).append(slot)
    plan, perm = [], []
    for bound in sorted(buckets):
        slots = buckets[bound]
        count = _next_pow2(len(slots))
        plan.append((bound, count))
        perm.extend(slots)
        perm.extend([n] * (count - len(slots)))
    if sum(bound * count for bound, count in plan) >= n * table_width:
        return None, None
    return tuple(plan), np.asarray(perm, np.int32)


def plan_streamed_pages(
    plan: Optional[BucketPlan], n_slots: int, table_width: int
) -> int:
    """Table entries (pages per pool) one dispatch walks; `None` (single
    launch) walks every slot's full table."""
    if plan is None:
        return n_slots * table_width
    return sum(bound * count for bound, count in plan)


def grouped_streamed_pages(
    plans, n_slots: int, table_width: int, n_groups: int = 1
):
    """Per-group `plan_streamed_pages` for one layer-major dispatch;
    `plans` is what `bucket_args_grouped` returned (a per-group tuple, a
    single plan, or None)."""
    if plans is None:
        return [n_slots * table_width] * n_groups
    if is_bucket_plan(plans):
        plans = (plans,) * n_groups
    return [plan_streamed_pages(p, n_slots, table_width) for p in plans]


def is_bucket_plan(plan) -> bool:
    """True for a SINGLE BucketPlan `((bound, count), ...)` as opposed to
    a per-group tuple of plans `(plan_or_None, ...)`."""
    return (
        isinstance(plan, tuple)
        and len(plan) > 0
        and isinstance(plan[0], tuple)
        and len(plan[0]) == 2
        and isinstance(plan[0][0], (int, np.integer))
    )


def _bucketing_off(strategy: str, kernel_impl: str, device) -> bool:
    """Plans are built only when a kernel walk runs: the plain version
    gathers the whole table and has nothing to bound."""
    return (
        resolve_bucket_strategy(strategy) == "none"
        or resolve_impl(kernel_impl, device) == "ref"
    )


def bucket_args(
    strategy: str,
    kernel_impl: str,
    eff_lengths,
    block_size: int,
    table_width: int,
    device="cuda",
):
    """`(plan, perm-on-device)` for one launch, or `(None, None)` for the
    single launch when the strategy is `"none"` OR the impl resolves to
    the plain version."""
    if _bucketing_off(strategy, kernel_impl, device):
        return None, None
    plan, perm = make_bucket_plan(eff_lengths, block_size, table_width)
    if perm is None:
        return plan, None
    return plan, torch.tensor(perm, dtype=torch.int64, device=device)


def plan_buckets_grouped(needs_by_group, table_width: int):
    """The planner half of `bucket_args_grouped`: per-group
    `make_bucket_plan` over live walk-entry needs, with host (numpy)
    permutations. Returns `(None, None)` when no group has a plan."""
    plans, perms = [], []
    for needs in needs_by_group:
        plan, perm = make_bucket_plan(None, 0, table_width, needs=needs)
        plans.append(plan)
        perms.append(perm)
    if all(p is None for p in plans):
        return None, None
    return tuple(plans), tuple(perms)


def bucket_args_grouped(
    strategy: str,
    kernel_impl: str,
    needs_by_group,
    table_width: int,
    device="cuda",
):
    """Per-group slot→bucket packing for one layer-major launch: a tuple
    of per-group plans (entries may be None) and the matching
    permutations on `device`, or `(None, None)` — the
    everywhere-single-launch path — when no group has a plan or the
    strategy/impl rules bucketing out."""
    if _bucketing_off(strategy, kernel_impl, device):
        return None, None
    plans, perms = plan_buckets_grouped(needs_by_group, table_width)
    if plans is None:
        return None, None
    return plans, tuple(
        None if p is None
        else torch.tensor(p, dtype=torch.int64, device=device)
        for p in perms
    )


# ---------------------------------------------------------------------------
# bit-plane weights (K3, K4, K5)
# ---------------------------------------------------------------------------

def quantize_and_pack(w: torch.Tensor, n_bits: int, group: int = 1,
                      impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W [K, M] float -> (planes [n_d, K*g//8, M] u8, scale [M] f32); the
    planes come from K5 on CUDA tensors (`impl` resolved on w's device),
    from `ref.pack_ref` otherwise — byte-identical either way."""
    w_q, scale = ref.quantize_ref(w, n_bits)
    if resolve_impl(impl, w.device) == "ref":
        return ref.pack_ref(w_q, n_bits, group), scale
    k, m = w_q.shape
    dpb = ref.check_dims(k, n_bits, group)
    u = (w_q + 2 ** (n_bits - 1)).to(torch.uint8)
    u_r = u.reshape(k // dpb, dpb, m).permute(1, 0, 2).contiguous()
    return pack_bitplanes(u_r, n_bits, group), scale


def bitplane_kernel(b: int):
    """The raw-contraction kernel for B rows: K3 up to `_GEMV_MAX_B`,
    K4 above."""
    return bitplane_gemv if b <= _GEMV_MAX_B else bitplane_gemm


def bitplane_matmul(
    x: torch.Tensor,        # [B, K] or [..., K]
    planes: torch.Tensor,   # [n_digits, K*g//8, M] uint8
    scale: torch.Tensor,    # [M] f32
    *,
    n_bits: int,
    group: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """y = x @ dequant(planes, scale) in x's dtype; batch dims flattened
    internally. `ref` is the reference's oracle (unpack, f32 matmul,
    scale); the kernel path runs K3/K4 for the raw f32 x @ U and then
    `(raw - 2^(n-1) * sum(x)) * scale`, as the reference does."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    xf = x.reshape(-1, k)
    m = planes.shape[-1]
    kernel = bitplane_kernel(xf.shape[0])
    with work.dispatch(kernel.__name__,
                       lambda: work.bitplane_work(x, planes, scale)):
        if resolve_impl(impl, x.device) == "ref":
            y = ref.bitplane_matmul_ref(xf, planes, scale, n_bits, group)
            return y.reshape(*lead, m)
        x_r = ref.prepare_x_ref(xf, group).contiguous()
        raw = kernel(x_r, planes, n_bits=n_bits, group=group)
        off = float(2 ** (n_bits - 1))
        sum_x = xf.float().sum(dim=-1, keepdim=True)
        y = (raw - off * sum_x) * scale[None, :]
        return y.to(x.dtype).reshape(*lead, m)


def bitplane_grouped_matmul(
    x: torch.Tensor,        # [P, K], rows sorted by expert
    planes: torch.Tensor,   # [E, n_digits, K*g//8, M] uint8
    scale: torch.Tensor,    # [E, M] f32
    offsets: torch.Tensor,  # [E + 1] int32: expert e's rows [o[e], o[e+1])
    expert: torch.Tensor,   # [P] int: each row's expert
    *,
    n_bits: int,
    group: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """y [P, M] = each row of x @ its expert's dequantized planes, in x's
    dtype. The kernel path is one K6 launch for the raw f32 contraction,
    then `bitplane_matmul`'s `(raw - 2^(n-1) * sum(x)) * scale` with each
    row's expert's scale. `ref` runs `bitplane_matmul_ref` through
    `ref.every_expert_ref` (every expert over every row, E times the
    work, for the CPU)."""
    with work.dispatch("bitplane_grouped",
                       lambda: work.grouped_work(x, planes, n_bits, group)):
        if resolve_impl(impl, x.device) == "ref":
            return ref.every_expert_ref(
                expert, planes.shape[0], lambda e: ref.bitplane_matmul_ref(
                    x, planes[e], scale[e], n_bits, group))
        x_r = ref.prepare_x_ref(x, group).contiguous()
        raw = bitplane_grouped(x_r, planes, offsets, n_bits=n_bits,
                               group=group)
        off = float(2 ** (n_bits - 1))
        sum_x = x.float().sum(dim=-1, keepdim=True)
        y = (raw - off * sum_x) * scale[expert]
        return y.to(x.dtype)


def packed_bytes(k: int, m: int, n_bits: int, group: int = 1) -> int:
    """Device bytes of the packed representation: planes + f32 scale."""
    nd = -(-n_bits // group)
    return nd * (k * group // 8) * m + 4 * m
