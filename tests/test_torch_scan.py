"""`repro_torch.models.scan`, the port's counterpart of `lax.scan`.

* On CPU tensors each loop that runs on `scan` — the mLSTM and the
  sLSTM over time, the dense attention's walk over q and kv blocks, the
  Mamba2 chunk scan and the MoE's dispatch chunks — gives outputs and
  gradients bit-equal to the loop as it was written before (copied
  below as `_loop_*`), at smoke widths.
* On meta tensors a scan of five or more steps runs steps 0, 1, 2 and
  the last and accounts for the rest: the FLOPs by op (forward and
  backward) and the `MemTracker` peak equal those of the whole loop on
  meta, without autograd, with it, and under activation checkpointing.
* A scan whose last step dispatches other ops than step 1, or whose
  step issues a collective, raises.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro_torch.models.scan as scan_mod
from repro_torch.dist import collectives
from repro_torch.dist.parallel import local_rows, row_linear
from repro_torch.dist.sharding import row_axes
from repro_torch.launch.dryrun import _run
from repro_torch.models import attention as A
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as E
from repro_torch.models import xlstm as X
from repro_torch.models.common import NEG_INF, rmsnorm
from repro_torch.models.mlp import swiglu
from repro_torch.quant.bitplane import pim_linear

# ---------------------------------------------------------------------------
# the loops as they were written before they ran on `scan`
# ---------------------------------------------------------------------------


def _loop_mlstm(params, x, *, n_heads):
    b, t, _ = x.shape
    q, k, v, it, ft, og = X._mlstm_inputs(params, x, n_heads, "auto")
    hd = q.shape[-1]
    state = X.mlstm_init_state(b, n_heads, hd, x.device)
    hs = []
    for i in range(t):
        state, h = X._mlstm_step(state, q[:, i], k[:, i], v[:, i], it[:, i],
                                 ft[:, i])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(b, t, n_heads * hd)
    y = row_linear((og * h).to(x.dtype), params["w_down"], n_heads * hd,
                   "auto")
    return y, state


def _loop_slstm(params, x, *, n_heads):
    b, t, d = x.shape
    gx = X._slstm_gates(params, x, "auto")
    state = X.slstm_init_state(b, d, x.device)
    hs = []
    for i in range(t):
        state, h = X._slstm_step(state, gx[:, i], params["r_gates"],
                                 n_heads)
        hs.append(h)
    y = pim_linear(torch.stack(hs, dim=1).to(x.dtype), params["w_out"],
                   "auto")
    return y, state


def _loop_chunked_gqa(q, k, v, q_pos, kv_pos, window, causal):
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kb = A._pick_block(s, A.KV_BLOCK)
    scale = hd ** -0.5
    outs = []
    for i in range(0, t, A.Q_BLOCK):
        qp = q_pos[i: i + A.Q_BLOCK]
        qb = qp.shape[0]
        qf = q[:, i: i + qb].reshape(b, qb, kvh, g, hd).float() * scale
        acc = torch.zeros((b, kvh, g, qb, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, kvh, g, qb), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, kvh, g, qb), dtype=torch.float32,
                        device=q.device)
        for j in range(0, s, kb):
            kp = kv_pos[j: j + kb]
            scores = torch.einsum("bqkgh,bskh->bkgqs", qf,
                                  k[:, j: j + kb].float())
            ok = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            if causal:
                ok = ok & (kp[None, :] <= qp[:, None])
            if window is not None:
                ok = ok & (kp[None, :] > qp[:, None] - window)
            scores = torch.where(ok, scores, NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            del scores
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + torch.einsum(
                "bkgqs,bskh->bkgqh", p, v[:, j: j + kb].float())
            m = m_new
            del p
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, qb, h * hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def _loop_mamba2(params, u, *, n_heads, n_state, d_inner, chunk):
    b, t, _ = u.shape
    h_heads, n = n_heads, n_state
    p = d_inner // n_heads
    proj = pim_linear(u, params["w_in"], "auto")
    z, xbc_raw, dt_raw = M._split_proj(proj, d_inner, n, h_heads)
    xbc = M._causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    x, b_in, c_in = torch.split(xbc, [d_inner, n, n], dim=-1)
    x = x.reshape(b, t, h_heads, p)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    lpad = (-t) % chunk
    xs, bs_, cs, dts = x, b_in.float(), c_in.float(), dt
    if lpad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, lpad))
        bs_ = F.pad(bs_, (0, 0, 0, lpad))
        cs = F.pad(cs, (0, 0, 0, lpad))
        dts = F.pad(dts, (0, 0, 0, lpad))
    h = torch.zeros((b, h_heads, p, n), dtype=torch.float32,
                    device=u.device)
    ys = []
    for c0 in range(0, t + lpad, chunk):
        sl = slice(c0, c0 + chunk)
        h, yk = M._chunk_step(h, xs[:, sl], bs_[:, sl], cs[:, sl],
                              dts[:, sl], a)
        ys.append(yk)
    y = torch.cat(ys, dim=1)[:, :t]
    y = y + params["D"][None, None, :, None] * x.float()
    y = y.reshape(b, t, d_inner).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return pim_linear(y, params["w_out"], "auto"), h


def _loop_moe(params, x, *, top_k, capacity_factor, chunk):
    rows = row_axes()
    routed = collectives.gather_apart(x, rows, 0) if rows else x
    b, t, d = routed.shape
    e = params["router"].shape[-1]
    n = b * t
    flat = routed.reshape(n, d)
    chunk = min(chunk, n)
    if n % chunk:
        pad = chunk - n % chunk
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    n_chunks = flat.shape[0] // chunk
    capacity = E.expert_capacity(chunk, top_k, e, capacity_factor)
    ys, fps, drs = [], [], []
    for c in range(n_chunks):
        y, fp, dr = E._dispatch_chunk(params, flat[c * chunk:(c + 1) * chunk],
                                      top_k, capacity, "silu", "auto")
        ys.append(y)
        fps.append(fp)
        drs.append(dr)
    y = torch.cat(ys)[:n].reshape(b, t, d)
    if rows:
        y = local_rows(y, rows)
    if "shared" in params:
        y = y + swiglu(params["shared"], x, "silu", "auto")
    return y, {"load_balance_loss": e * torch.stack(fps).mean(dim=0).sum(),
               "dropped_fraction": torch.stack(drs).mean()}


# ---------------------------------------------------------------------------
# the cases: (params, input, the function on scan, the loop)
# ---------------------------------------------------------------------------

def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _x(shape, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _attention_case(t):
    """q / k / v of a causal walk over `t` positions (two kv heads, g = 2),
    window `t // 3`, as a function of one tensor holding all three."""
    def split(qkv):
        pos = torch.arange(t, device=qkv.device)
        return (qkv[..., :4, :], qkv[..., 4:6, :], qkv[..., 6:, :], pos, pos,
                t // 3, True)

    def new(qkv):
        return A._chunked_gqa(*split(qkv)), None

    def old(qkv):
        return _loop_chunked_gqa(*split(qkv)), None
    return {}, (1, t, 8, 8), new, old


def _cases():
    cases = {}
    p = X.init_mlstm(16, 2, 2, _gen(), "cpu")
    cases["mlstm"] = (
        p, (2, 9, 16),
        lambda p, x: X.mlstm_forward(p, x, n_heads=2, return_state=True),
        lambda p, x: _loop_mlstm(p, x, n_heads=2))
    p = X.init_slstm(16, 2, _gen(), "cpu")
    cases["slstm"] = (
        p, (2, 9, 16),
        lambda p, x: X.slstm_forward(p, x, n_heads=2, return_state=True),
        lambda p, x: _loop_slstm(p, x, n_heads=2))
    p = M.init_mamba2(16, 32, 4, 8, 4, _gen(), "cpu")
    ssm = dict(n_heads=4, n_state=8, d_inner=32, chunk=8)
    cases["mamba2"] = (
        p, (2, 45, 16),
        lambda p, x: (lambda y, st: (y, st[0]))(
            *M.mamba2_forward(p, x, return_state=True, **ssm)),
        lambda p, x: _loop_mamba2(p, x, **ssm))
    p = E.init_moe(16, 24, 4, 1, _gen(), "cpu")
    route = dict(top_k=2, capacity_factor=0.5, chunk=8)
    cases["moe"] = (
        p, (4, 10, 16),
        lambda p, x: E.moe_forward(p, x, **route),
        lambda p, x: _loop_moe(p, x, **route))
    # at the blocks of `small_blocks`: 10 q blocks of 5 kv blocks; 10 q
    # blocks and a ragged one, of 21
    for t in (160, 168):
        params, shape, new, old = _attention_case(t)
        cases[f"attention-{t}"] = (params, shape, lambda p, x, f=new: f(x),
                                   lambda p, x, f=old: f(x))
    return cases


CASES = _cases()


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """The attention walk's blocks cut to 16 q rows and 32 kv rows, so a
    smoke-sized walk has as many blocks as a long prompt's."""
    monkeypatch.setattr(A, "Q_BLOCK", 16)
    monkeypatch.setattr(A, "KV_BLOCK", 32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _outputs_and_grads(fn, params, shape):
    params = _map(lambda v: v.clone().requires_grad_(True), params)
    x = _x(shape).requires_grad_(True)
    outs = _leaves(fn(params, x))
    weights = [_x(o.shape, seed=2 + i) for i, o in enumerate(outs)]
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights)
               if o.is_floating_point())
    inputs = [x] + _leaves(params)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [o.detach() for o in outs], grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_scan_is_the_loop_bit_for_bit_on_the_cpu(name):
    params, shape, new, old = CASES[name]
    got_out, got_grads = _outputs_and_grads(new, params, shape)
    want_out, want_grads = _outputs_and_grads(old, params, shape)
    assert len(got_out) == len(want_out)
    for g, w in zip(got_out, want_out):
        assert torch.equal(g, w)
    for g, w in zip(got_grads, want_grads):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the accounting on meta tensors
# ---------------------------------------------------------------------------

#: how each case runs on meta: without autograd, with it, and with the
#: step under non-reentrant activation checkpointing
MODES = ("no_grad", "grad", "checkpoint")


def _meta_count(name, mode):
    """(FLOPs by op, temp bytes) of one counted run of a case on meta,
    as the dry run counts a step (`dryrun._run`)."""
    params, shape, new, _ = CASES[name]
    mp = _map(lambda v: torch.empty_like(v, device="meta").requires_grad_(
        mode != "no_grad"), params)
    x = torch.empty(shape, device="meta", requires_grad=mode != "no_grad")

    def step():
        if mode == "no_grad":
            with torch.no_grad():
                return new(mp, x)
        fn = new if mode == "grad" else (
            lambda p, x: torch.utils.checkpoint.checkpoint(
                new, p, x, use_reentrant=False))
        outs = [o for o in _leaves(fn(mp, x)) if o.is_floating_point()]
        loss = sum(o.float().sum() for o in outs)
        return torch.autograd.grad(loss, [x] + _leaves(mp),
                                   allow_unused=True)
    count, temp, note = _run(step, [mp, x])
    assert note is None, note
    return count["flops_by_op"], temp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_shortened_scan_counts_what_the_whole_loop_counts(monkeypatch, name,
                                                          mode):
    """The shortened scan's FLOPs by op and `MemTracker` temp bytes equal
    the whole loop's on meta (`MIN_STEPS` past every loop's length)."""
    short = _meta_count(name, mode)
    monkeypatch.setattr(scan_mod, "MIN_STEPS", 10 ** 9)
    whole = _meta_count(name, mode)
    assert short == whole
    assert sum(whole[0].values()) > 0 and whole[1] > 0


def test_scan_runs_few_steps_on_meta(monkeypatch):
    """On meta a scan of 40 steps runs 4 of them; on the CPU all 40."""
    ran = []

    def body(c, i):
        ran.append(i)
        return c * 2.0, (c + 1.0,)
    for device, want in (("meta", [0, 1, 2, 39]), ("cpu", list(range(40)))):
        ran.clear()
        c, (ys,) = scan_mod.scan(body, torch.ones(3, device=device), 40,
                                 join=(("stack", 0),))
        assert ran == want
        assert ys.shape == (40, 3) and c.shape == (3,)


def test_steps_that_are_not_alike_raise():
    def body(c, i):
        return c, (torch.zeros(3 if i < 5 else 4, device="meta"),)
    with pytest.raises(RuntimeError, match="not alike"):
        scan_mod.scan(body, torch.ones(3, device="meta"), 6,
                      join=(("cat", 0),))


def test_a_step_that_issues_a_collective_raises():
    def body(c, i):
        collectives._count("all_reduce", 8)
        return c + 1.0, ()
    with pytest.raises(RuntimeError, match="collective"):
        scan_mod.scan(body, torch.ones(3, device="meta"), 6)
