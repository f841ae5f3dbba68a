"""Bucket planner of the PyTorch port against the JAX reference: the
port's `make_bucket_plan` / `bucket_args_grouped` must give the
reference's `(plan, perm)` exactly — on ragged needs, windowed needs and
0/1-slot launches — and follow the same gate (no plans when the impl
resolves to the plain version)."""

import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops


def _same_plan(a, b):
    (pa, ma), (pb, mb) = a, b
    assert pa == pb
    if ma is None or mb is None:
        assert ma is None and mb is None
    else:
        np.testing.assert_array_equal(np.asarray(ma), np.asarray(mb))


CASES = [
    ([], 4, 8),                       # n = 0 slots
    ([1], 4, 8),                      # n = 1
    ([17], 4, 8),
    ([5, 12, 1], 4, 3),
    ([0, 12, 4], 4, 3),
    ([3, 40, 7, 90, 1, 2, 64, 33], 4, 32),
    ([1, 1, 1, 1], 16, 64),
    ([2048, 0, 700, 1100, 35, 512, 1, 999], 16, 128),
]


@pytest.mark.parametrize("lengths,bs,width", CASES)
@pytest.mark.parametrize("strategy", ["pow2", "none"])
def test_make_bucket_plan_matches_reference(lengths, bs, width, strategy):
    lens = np.asarray(lengths, np.int32)
    _same_plan(
        tops.make_bucket_plan(lens, bs, width, strategy),
        jops.make_bucket_plan(lens, bs, width, strategy),
    )
    assert tops.plan_streamed_pages(
        tops.make_bucket_plan(lens, bs, width, strategy)[0], len(lens), width
    ) == jops.plan_streamed_pages(
        jops.make_bucket_plan(lens, bs, width, strategy)[0], len(lens), width
    )


@pytest.mark.parametrize("needs_by_group", [
    [np.array([3, 1, 8, 2])],                           # one global group
    [np.array([3, 1, 8, 2]), np.array([1, 1, 2, 2])],   # global + windowed
    [np.array([1])],
    [np.array([8, 8, 8, 8]), np.array([8, 1, 8, 1])],   # degenerate group
])
def test_grouped_plans_match_reference(needs_by_group):
    width = 8
    jplans, jperms = jops.bucket_args_grouped(
        "pow2", "pallas_interpret", needs_by_group, width
    )
    tplans, tperms = tops.plan_buckets_grouped(needs_by_group, width)
    assert tplans == jplans
    if jplans is not None:
        for a, b in zip(jperms, tperms):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(np.asarray(a), b)
    assert tops.grouped_streamed_pages(
        tplans, 4, width, len(needs_by_group)
    ) == jops.grouped_streamed_pages(jplans, 4, width, len(needs_by_group))


def test_bucket_args_gate_follows_the_resolved_impl():
    """The plain version ignores plans, so none are built for it: `ref`
    anywhere and `auto` on CPU tensors give the single launch — as the
    reference's `ref` / `auto`-off-TPU do."""
    needs = [np.array([1, 9, 2])]
    assert jops.bucket_args_grouped("pow2", "ref", needs, 16) == (None, None)
    for impl in ("ref", "auto"):
        assert tops.bucket_args_grouped(
            "pow2", impl, needs, 16, device="cpu") == (None, None)
        assert tops.bucket_args(
            "pow2", impl, [5, 40], 4, 16, device="cpu") == (None, None)
    assert tops.bucket_args_grouped(
        "none", "ref", needs, 16, device="cpu") == (None, None)


def test_resolve_impl_rules():
    assert tops.resolve_impl("auto", "cpu") == "ref"
    assert tops.resolve_impl("auto", torch.device("cuda")) == "cuda"
    assert tops.resolve_impl("ref", "cpu") == "ref"
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        tops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.resolve_impl("pallas", "cpu")
    with pytest.raises(ValueError, match="bucket_strategy"):
        tops.resolve_bucket_strategy("pow3")


@given(
    lengths=st.lists(st.integers(0, 300), min_size=0, max_size=12),
    bs=st.sampled_from([1, 4, 16]),
    width=st.integers(1, 40),
    windowed=st.booleans(),
)
def test_planner_property_matches_reference(lengths, bs, width, windowed):
    lens = np.asarray(lengths, np.int64)
    if windowed:
        needs = np.maximum(-(-np.maximum(lens, 1) // bs) - lens % 3, 1)
        _same_plan(
            tops.make_bucket_plan(None, 0, width, needs=needs),
            jops.make_bucket_plan(None, 0, width, needs=needs),
        )
    else:
        _same_plan(
            tops.make_bucket_plan(lens, bs, width),
            jops.make_bucket_plan(lens, bs, width),
        )
