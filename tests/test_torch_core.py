"""The port's simulator path against the reference, on the CPU.

`repro_torch.core` (ISA, bit-exact PIM array, IMAGine GEMV engine, Gold
Standard, latency models, FPGA registries, the rest of `tpu_gold`, the
step models of `reduction`), `configs/imagine_u55.py` and
`launch/paper_tables.py`, each given the same seeded numpy inputs as its
reference twin. Tolerances: none for the simulator (register file, y,
cycles, instruction counts and shifted-out words equal bit for bit) and
for the closed-form models (equal floats); the Table IX fits, which run
the same numpy least squares on each side, within 1e-9.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmarks import paper_tables as j_tables
from repro.configs import imagine_u55 as j_u55
from repro.core import fpga_devices as j_fpga
from repro.core import gemv_engine as j_gemv
from repro.core import gold_standard as j_gold
from repro.core import isa as j_isa
from repro.core import latency_models as j_lat
from repro.core import pim_array as j_pim
from repro.core import reduction as j_red
from repro.core import tpu_gold as j_tpu
from repro_torch.bridge import pim_array_from_reference
from repro_torch.configs import ARCH_IDS, get_config, imagine_u55
from repro_torch.core import (
    fpga_devices,
    gemv_engine,
    gold_standard,
    isa,
    latency_models,
    pim_array,
    reduction,
    tpu_gold,
)
from repro_torch.launch import paper_tables

CPU = "cpu"


def _port_instr(instr):
    return isa.Instr(isa.Op(int(instr.op)), instr.addr1, instr.addr2,
                     instr.imm)


def _same_state(ref, port):
    np.testing.assert_array_equal(port.rf.numpy(), ref.rf)
    np.testing.assert_array_equal(port.enable.numpy(), ref.enable)
    assert (port.ptr, port.n_bits, port.acc_bits, port.cycles,
            port.instr_count) == (ref.ptr, ref.n_bits, ref.acc_bits,
                                  ref.cycles, ref.instr_count)
    assert len(port.out_buffer) == len(ref.out_buffer)
    for got, want in zip(port.out_buffer, ref.out_buffer):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ISA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", list(j_isa.Op), ids=lambda o: o.name)
def test_isa_encoding_and_costs_match(op):
    port_op = isa.Op[op.name]
    assert int(port_op) == int(op)
    assert (port_op in isa.SINGLE_CYCLE) == (op in j_isa.SINGLE_CYCLE)
    for addr1, addr2, imm in [(0, 0, 0), (1023, 1, 31), (517, 1023, 7),
                              (64, 200, 3)]:
        ref = j_isa.Instr(op, addr1, addr2, imm)
        port = isa.Instr(port_op, addr1, addr2, imm)
        word = ref.encode()
        assert port.encode() == word
        assert _port_instr(j_isa.Instr.decode(word)) == isa.Instr.decode(word)
        assert port.is_single_cycle == ref.is_single_cycle
        for n_bits in (4, 8, 32):
            for acc_bits in (16, 24, 32):
                assert (isa.cycle_cost(port, n_bits, acc_bits)
                        == j_isa.cycle_cost(ref, n_bits, acc_bits))
    assert isa.assemble([isa.Instr(port_op, 3, 4, 5)]) == j_isa.assemble(
        [j_isa.Instr(op, 3, 4, 5)])


@pytest.mark.parametrize("fields", [dict(addr1=1 << 10), dict(addr2=-1),
                                    dict(imm=32)])
def test_isa_range_errors_match(fields):
    with pytest.raises(ValueError) as want:
        j_isa.Instr(j_isa.Op.ADD, **fields).encode()
    with pytest.raises(ValueError) as got:
        isa.Instr(isa.Op.ADD, **fields).encode()
    assert str(got.value) == str(want.value)
    for word in (-1, 1 << isa.INSTR_BITS):
        with pytest.raises(ValueError):
            isa.Instr.decode(word)


# ---------------------------------------------------------------------------
# PimArray: primitives and random programs from a random register file
# ---------------------------------------------------------------------------

GEOM = dict(rows=2, cols=4, lanes=4, depth=160)
ADDR_MAX = GEOM["depth"] - 32   # every operand region fits the depth


def _random_pair(seed, acc_bits=24, n_bits=8):
    """A reference array in a random state and the port's copy of it."""
    rng = np.random.default_rng(seed)
    ref = j_pim.PimArray(j_pim.ArrayGeometry(**GEOM))
    ref.rf[...] = rng.integers(0, 2, size=ref.rf.shape, dtype=np.uint8)
    ref.enable[...] = rng.integers(0, 2, size=ref.enable.shape).astype(bool)
    ref.acc_bits, ref.n_bits = acc_bits, n_bits
    ref.ptr, ref.cycles, ref.instr_count = 96, 11, 3
    return ref, pim_array_from_reference(ref, CPU)


def _run_both(ref, port, program):
    _same_state(ref, port)
    for instr in program:
        want = ref.execute([instr])
        assert port.execute([_port_instr(instr)]) == want, instr
        _same_state(ref, port)


I = j_isa.Instr
O = j_isa.Op

PRIMITIVES = {
    "add": [I(O.SETPTR, 100), I(O.ADD, 0, 32), I(O.ADD, 100, 100)],
    "sub": [I(O.SETPTR, 100), I(O.SUB, 0, 32), I(O.SUB, 100, 100)],
    "mult": [I(O.SETPTR, 100), I(O.MULT, 0, 8), I(O.SETPREC, imm=5),
             I(O.MULT, 17, 3)],
    "mult_32bit_into_narrow_acc": [I(O.SETPREC, imm=0), I(O.SETPTR, 128),
                                   I(O.MULT, 0, 40)],
    "macc": [I(O.SETPTR, 100), I(O.MACC, 0, 8), I(O.MACC, 16, 24),
             I(O.MACC, 100, 3)],
    "fold": [I(O.SETPTR, 64), I(O.FOLD, imm=0), I(O.FOLD, imm=1),
             I(O.FOLD, imm=2), I(O.FOLD, imm=9)],
    "hop": [I(O.SETPTR, 64), I(O.HOP, imm=0), I(O.HOP, imm=1),
            I(O.HOP, imm=2), I(O.HOP, imm=7)],
    "fold_masked_hop_not": [I(O.SELBLK, imm=6), I(O.SETPTR, 30),
                            I(O.FOLD, imm=0), I(O.HOP, imm=0),
                            I(O.SELROW, imm=1), I(O.FOLD, imm=1),
                            I(O.HOP, imm=1)],
    "bcast": [I(O.SETPTR, 40), I(O.BCAST, 1023, 5), I(O.SETPREC, imm=0),
              I(O.BCAST, 1, 1023), I(O.SETPREC, imm=3), I(O.SELBLK, imm=2),
              I(O.BCAST, 6, 0)],
    "shiftout": [I(O.SETPTR, 64), I(O.SHIFTOUT, imm=2), I(O.SETPTR, 0),
                 I(O.SHIFTOUT)],
    "select": [I(O.SELBLK, imm=5), I(O.SETPTR, 120), I(O.ADD, 0, 16),
               I(O.SELROW, imm=1), I(O.MACC, 8, 24), I(O.SELALL),
               I(O.SUB, 120, 40), I(O.NOP), I(O.END), I(O.ADD, 0, 0)],
}


@pytest.mark.parametrize("acc_bits", [16, 24, 32])
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_reference(name, acc_bits):
    ref, port = _random_pair(seed=len(name) * 7 + acc_bits,
                             acc_bits=acc_bits)
    _run_both(ref, port, PRIMITIVES[name])


def _random_program(rng, n):
    g = GEOM
    addr = lambda: int(rng.integers(0, ADDR_MAX + 1))  # noqa: E731
    draw = {
        O.NOP: lambda: I(O.NOP),
        O.SETPTR: lambda: I(O.SETPTR, addr()),
        O.SELBLK: lambda: I(O.SELBLK, imm=int(rng.integers(
            0, g["rows"] * g["cols"]))),
        O.SELROW: lambda: I(O.SELROW, imm=int(rng.integers(0, g["rows"]))),
        O.SELALL: lambda: I(O.SELALL),
        O.SETPREC: lambda: I(O.SETPREC, imm=int(rng.integers(0, 32))),
        O.BCAST: lambda: I(O.BCAST, int(rng.integers(0, 1024)),
                           int(rng.integers(0, 1024))),
        O.ADD: lambda: I(O.ADD, addr(), addr()),
        O.SUB: lambda: I(O.SUB, addr(), addr()),
        O.MULT: lambda: I(O.MULT, addr(), addr()),
        O.MACC: lambda: I(O.MACC, addr(), addr()),
        O.FOLD: lambda: I(O.FOLD, imm=int(rng.integers(0, 4))),
        O.HOP: lambda: I(O.HOP, imm=int(rng.integers(0, 4))),
        O.SHIFTOUT: lambda: I(O.SHIFTOUT, imm=int(rng.integers(0, 4))),
    }
    ops = list(draw)
    return [draw[ops[int(rng.integers(0, len(ops)))]]() for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_random_program_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    ref, port = _random_pair(seed, acc_bits=int(rng.choice([16, 24, 32])))
    _run_both(ref, port, _random_program(rng, 40))


def test_host_dma_matches_reference():
    rng = np.random.default_rng(7)
    ref, port = _random_pair(1)
    values = rng.integers(-(1 << 11), 1 << 11, size=(2, 3, 4, 5))
    ref.host_write_block(values, 7, 12)
    port.host_write_block(values, 7, 12)
    ref.host_write(1, 2, 3, 90, -5, 9)
    port.host_write(1, 2, 3, 90, -5, 9)
    _same_state(ref, port)
    for addr, nbits in [(7, 12), (90, 9), (0, 32), (31, 1)]:
        got = port.read_words(addr, nbits)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), ref.read_words(addr, nbits))
        assert (port.host_read(1, 2, 3, addr, nbits)
                == ref.host_read(1, 2, 3, addr, nbits))


@pytest.mark.parametrize("rows, cols, lanes", [(1, 3, 4), (1, 2, 5)])
def test_geometry_validation_matches(rows, cols, lanes):
    with pytest.raises(ValueError) as want:
        j_pim.PimArray(j_pim.ArrayGeometry(rows, cols, lanes, 64))
    with pytest.raises(ValueError) as got:
        pim_array.PimArray(pim_array.ArrayGeometry(rows, cols, lanes, 64), CPU)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# ImagineGemv
# ---------------------------------------------------------------------------

FIG7SIM = dict(rows=4, cols=8, lanes=8, depth=512, n_bits=8, acc_bits=24)
GEMV_CASES = {
    # the U55 config's smoke() is the reference tests' 2x4x4 / depth 256
    "smoke": (None, [(2, 4), (5, 16), (8, 32), (3, 8), (1, 1)]),
    "4bit_2x2x4_d128": (dict(rows=2, cols=2, lanes=4, depth=128, n_bits=4,
                             acc_bits=16), [(4, 8), (3, 5)]),
    "fig7sim": (FIG7SIM, list(paper_tables.FIG7_SIM_GEMVS)),
}


def _engines(fields):
    if fields is None:
        return j_gemv.ImagineGemv(j_u55.smoke()), gemv_engine.ImagineGemv(
            imagine_u55.smoke(), CPU)
    return (j_gemv.ImagineGemv(j_gemv.ImagineConfig(**fields)),
            gemv_engine.ImagineGemv(gemv_engine.ImagineConfig(**fields), CPU))


@pytest.mark.parametrize("name", sorted(GEMV_CASES))
def test_run_gemv_matches_reference_bit_for_bit(name):
    fields, shapes = GEMV_CASES[name]
    ref, port = _engines(fields)
    rng = np.random.default_rng(0)
    half = 1 << (ref.cfg.n_bits - 1)
    # one engine for every shape: stale words of one GEMV stay in the
    # register file under the next, on both sides alike
    for m, d in shapes:
        w = rng.integers(-half, half, size=(m, d))
        x = rng.integers(-half, half, size=(d,))
        y_want, c_want = ref.run_gemv(w, x)
        # the port takes tensors as well as numpy arrays
        y, cycles = port.run_gemv(torch.from_numpy(w), x)
        assert y.dtype == torch.int64 and y.shape == (m,)
        np.testing.assert_array_equal(y.numpy(), y_want)
        np.testing.assert_array_equal(y.numpy(), w @ x)
        assert cycles == c_want == port.analytic_cycles(m, d)
        _same_state(ref.array, port.array)


def test_load_placement_matches_reference_loops():
    """The tensor placement of W and x equals the reference's loops over
    every (row, column), zero slots included."""
    ref, port = _engines(FIG7SIM)
    rng = np.random.default_rng(3)
    for m, d in [(9, 70), (4, 128), (1, 3)]:
        w = rng.integers(-128, 128, size=(m, d))
        x = rng.integers(-128, 128, size=(d,))
        plan = ref.plan(m, d)
        assert dataclasses.asdict(port.plan(m, d)) == dataclasses.asdict(plan)
        ref.load_matrix(w, plan)
        port.load_matrix(w, port.plan(m, d))
        ref.load_vector(x, plan)
        port.load_vector(x, port.plan(m, d))
        _same_state(ref.array, port.array)


def _closed_forms(cls, cfg):
    """An engine for the plan, the program and the cycle model only: no
    register file is built (the U55's is the card's work)."""
    eng = cls.__new__(cls)
    eng.cfg = cfg
    return eng


@pytest.mark.parametrize("fields, m, d", [
    (FIG7SIM, 8, 32), (dict(rows=126, cols=32, lanes=16, depth=1024), 1024,
                       1024),
    (dict(rows=126, cols=32, lanes=16, depth=1024), 2048, 2048),
    (dict(rows=126, cols=32, lanes=16, depth=1024), 126, 512),
    (dict(rows=3, cols=16, lanes=2, depth=4096, n_bits=16), 40, 300),
])
def test_program_and_cycle_model_match(fields, m, d):
    ref = _closed_forms(j_gemv.ImagineGemv, j_gemv.ImagineConfig(**fields))
    port = _closed_forms(gemv_engine.ImagineGemv,
                         gemv_engine.ImagineConfig(**fields))
    plan = port.plan(m, d)
    for p in range(plan.passes):
        assert port.build_pass_program(plan, p) == [
            _port_instr(i) for i in ref.build_pass_program(ref.plan(m, d), p)]
    assert port.analytic_cycles(m, d) == ref.analytic_cycles(m, d)
    assert port.reduction_cycles(m, d) == ref.reduction_cycles(m, d)
    assert port.vector_load_cycles(plan) == ref.vector_load_cycles(
        ref.plan(m, d))


def test_u55_pinned_cycles_and_instructions():
    """The full U55 array's closed forms (the card runs the GEMVs)."""
    port = _closed_forms(gemv_engine.ImagineGemv, imagine_u55.config())
    assert [port.analytic_cycles(m, m) for m in (1024, 2048)] == [10249, 29187]
    assert port.analytic_cycles(126, 512) == 856
    for m, instrs in [(1024, 144), (2048, 306)]:
        plan = port.plan(m, m)
        assert sum(len(port.build_pass_program(plan, p))
                   for p in range(plan.passes)) == instrs
    with pytest.raises(ValueError, match="does not fit"):
        port.plan(4096, 4096)


@pytest.mark.parametrize("n", [1, 2, 4, 16, 32, 64, 256])
def test_reduction_model_cycles_match(n):
    for n_acc in (16, 24, 32):
        for k in (4, 16):
            assert (gemv_engine.reduction_model_cycles(n_acc, n, k)
                    == j_gemv.reduction_model_cycles(n_acc, n, k))


def _guard_error(make, call):
    with pytest.raises(ValueError) as exc:
        call(make())
    return str(exc.value)


@pytest.mark.parametrize("case", ["capacity", "w_range", "x_range",
                                  "w_negative_range"])
def test_guards_raise_the_same_errors(case):
    calls = {
        "capacity": lambda e: e.plan(4, 100_000),
        "w_range": lambda e: e.run_gemv(np.full((2, 4), 200),
                                        np.zeros(4, np.int64)),
        "x_range": lambda e: e.run_gemv(np.zeros((2, 4), np.int64),
                                        np.full(4, 128)),
        "w_negative_range": lambda e: e.run_gemv(np.full((2, 4), -129),
                                                 np.zeros(4, np.int64)),
    }
    want = _guard_error(lambda: j_gemv.ImagineGemv(j_u55.smoke()),
                        calls[case])
    got = _guard_error(lambda: gemv_engine.ImagineGemv(imagine_u55.smoke(),
                                                       CPU), calls[case])
    assert got == want
    assert ("does not fit" if case == "capacity" else "out of") in got


def test_card_is_the_default_device(monkeypatch):
    """Without a card the simulator raises unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pim_array.PimArray(pim_array.ArrayGeometry(1, 2, 4, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gemv_engine.ImagineGemv(imagine_u55.smoke())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper_tables.fig7_simulator_validation()
    arr = pim_array.PimArray(pim_array.ArrayGeometry(1, 2, 4, 64), CPU)
    assert arr.rf.device.type == "cpu" and arr.rf.dtype == torch.uint8


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_imagine_u55_config_matches_reference():
    assert dataclasses.asdict(imagine_u55.config()) == dataclasses.asdict(
        j_u55.config())
    assert dataclasses.asdict(imagine_u55.smoke()) == dataclasses.asdict(
        j_u55.smoke())
    cfg = get_config("imagine-u55")
    assert cfg == imagine_u55.config()
    assert cfg.geometry.n_pe == 64512 == fpga_devices.DEVICES["U55"].max_pe
    assert get_config("imagine-u55", smoke=True) == imagine_u55.smoke()
    assert "imagine-u55" not in ARCH_IDS


# ---------------------------------------------------------------------------
# Gold Standard, latency models, FPGA registries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(paper_tables.table9_cases()))
def test_table9_fit_matches_reference(name):
    ref_cases = {
        "SPAR-2-linear": lambda n, p: j_lat.spar2_linear_array(n, p),
        "SPAR-2-binary": lambda n, p: j_lat.spar2_binary_array(n, p),
        "CCB-CoMeFa": j_lat.reduction_cycles_for_fit("CCB"),
        "IMAGine": lambda n, p: j_gemv.reduction_model_cycles(n, p, k=16),
    }
    want = j_gold.fit_reduction_model(ref_cases[name], n_bits=32)
    got = gold_standard.fit_reduction_model(
        paper_tables.table9_cases()[name], n_bits=32)
    for field in ("a", "b", "c", "rmse"):
        assert abs(getattr(got, field) - getattr(want, field)) <= 1e-9, field
    assert got.n_bits == want.n_bits
    assert got.interpretation() == want.interpretation()


def _same_float(a, b):
    if a is None or b is None:
        return a is b
    return (math.isnan(a) and math.isnan(b)) or a == b


@pytest.mark.parametrize("name", sorted(j_fpga.PUBLISHED))
def test_published_design_scores_match(name):
    want, got = j_gold.score_published(name), gold_standard.score_published(name)
    assert dataclasses.asdict(fpga_devices.PUBLISHED[name]) == dataclasses.asdict(
        j_fpga.PUBLISHED[name])
    for field in ("clock_fraction", "scaling_fraction", "bandwidth_fraction"):
        assert _same_float(getattr(got, field), getattr(want, field)), field
    assert got.is_gold == want.is_gold
    p, jp = fpga_devices.PUBLISHED[name], j_fpga.PUBLISHED[name]
    assert _same_float(p.rel_f_pim, jp.rel_f_pim)
    assert _same_float(p.rel_f_sys, jp.rel_f_sys)


def test_gold_equations_and_ranges_match():
    for n, p, a, b, c in [(32, 16, 1.0, 0.5, 10), (8, 2, 0.2, 0.0, 0.0),
                          (16, 256, 1.7, 32.0, 3.5)]:
        assert (gold_standard.array_reduction_gold(n, p, a, b, c)
                == j_gold.array_reduction_gold(n, p, a, b, c))
        assert (gold_standard.inblock_reduction_gold(n, p, a)
                == j_gold.inblock_reduction_gold(n, p, a))
    for n_bits in (8, 32):
        for a in (0.0, 0.03, 0.2, 1.2, 2.0, 5.0, 9.0):
            for b in (0.0, 0.05, 0.9, 3.0, 32.0):
                for c in (-1.0, 0.0, 143.0):
                    assert (gold_standard.GoldRange(n_bits).classify(a, b, c)
                            == j_gold.GoldRange(n_bits).classify(a, b, c))
    with pytest.raises(ValueError):
        gold_standard.array_reduction_gold(32, 0.5, 1, 1, 1)


@pytest.mark.parametrize("design", sorted(j_lat.DESIGN_MODELS))
def test_design_models_match(design):
    n_pe = j_fpga.DEVICES["U55"].max_pe
    want, got = j_lat.DESIGN_MODELS[design], latency_models.DESIGN_MODELS[design]
    for n_bits in (8, 16, 32):
        for d in (256, 512, 1024, 2048, 4096):
            assert got.gemv_cycles(d, n_bits, n_pe) == want.gemv_cycles(
                d, n_bits, n_pe)
            assert _same_float(got.gemv_time_us(d, n_bits, n_pe),
                               want.gemv_time_us(d, n_bits, n_pe))
    fn, jfn = (latency_models.reduction_cycles_for_fit(design),
               j_lat.reduction_cycles_for_fit(design))
    for n in (8, 32):
        for p in (2, 16, 256):
            assert fn(n, p) == jfn(n, p)


@pytest.mark.parametrize("design", sorted(j_lat.TABLE_IV))
def test_table_iv_models_match(design):
    for n in (8, 16, 32):
        for p in (2, 16, 64, 256):
            for k in (8, 16):
                assert (latency_models.total_reduction_cycles(design, n, p, k)
                        == j_lat.total_reduction_cycles(design, n, p, k))
                for part in ("block", "array"):
                    arg = k if part == "block" else p
                    assert (latency_models.TABLE_IV[design][part](n, arg)
                            == j_lat.TABLE_IV[design][part](n, arg))
    for mac in ("mac_imagine", "mac_imagine_slice4", "mac_spar2",
                "mac_ccb_comefa", "mac_bramac"):
        for n in (4, 8, 16, 32):
            assert getattr(latency_models, mac)(n) == getattr(j_lat, mac)(n)


@pytest.mark.parametrize("device_id", sorted(j_fpga.DEVICES))
def test_devices_and_utilization_match(device_id):
    got, want = fpga_devices.DEVICES[device_id], j_fpga.DEVICES[device_id]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.max_pe, got.bram_period_ns, got.total_luts) == (
        want.max_pe, want.bram_period_ns, want.total_luts)
    for frac in (1.0, 0.55, 0.23):
        assert dataclasses.asdict(fpga_devices.estimate_utilization(
            device_id, frac)) == dataclasses.asdict(
                j_fpga.estimate_utilization(device_id, frac))
        for nbits in (4, 8, 16):
            assert (fpga_devices.ideal_scaling_tops(device_id, frac, nbits)
                    == j_fpga.ideal_scaling_tops(device_id, frac, nbits))
            assert (fpga_devices.peak_tops(got.max_pe, 500.0, nbits, radix=4)
                    == j_fpga.peak_tops(want.max_pe, 500.0, nbits, radix=4))


def test_registry_constants_match():
    for name in ("PES_PER_RAMB36", "DELAY_BUDGET_NS", "RIMA_SCALING_POINTS",
                 "LUT_PER_BLOCK", "FF_PER_BLOCK", "CTRL_LUT_PER_TILE",
                 "CTRL_FF_PER_TILE", "BLOCKS_PER_TILE"):
        assert getattr(fpga_devices, name) == getattr(j_fpga, name), name
    for family in fpga_devices.DELAY_BUDGET_NS:
        assert (fpga_devices.logic_levels_at_bram_fmax(family)
                == j_fpga.logic_levels_at_bram_fmax(family))
    for n in (4, 8, 16, 32):
        assert fpga_devices.mac_cycles_radix2(n) == j_fpga.mac_cycles_radix2(n)
        assert fpga_devices.mac_cycles_radix4(n) == j_fpga.mac_cycles_radix4(n)


# ---------------------------------------------------------------------------
# tpu_gold's helpers and reduction's step models
# ---------------------------------------------------------------------------

def test_tpu_gold_helpers_match_at_the_same_chip():
    h = tpu_gold.H100_SXM
    j_h100 = j_tpu.ChipSpec(h.name, h.peak_flops_bf16, h.hbm_bandwidth,
                            h.hbm_capacity, h.ici_bandwidth, h.ici_links)
    assert tpu_gold.ridge_batch_for_gemm() == 296
    for b in (1, 2, 4):
        assert (tpu_gold.ridge_batch_for_gemm(h, b)
                == j_tpu.ridge_batch_for_gemm(j_h100, b))
    assert (tpu_gold.decode_step_lower_bound_s(3.1e9, 4.8e8)
            == j_tpu.decode_step_lower_bound_s(3.1e9, 4.8e8, j_h100))
    for n, t in [(1.5e9, 1024), (27e9, 8)]:
        assert tpu_gold.model_flops_train(n, t) == j_tpu.model_flops_train(n, t)
        assert tpu_gold.model_flops_serve(n, t) == j_tpu.model_flops_serve(n, t)
    for bits in (1, 4, 8):
        assert (tpu_gold.bitplane_bandwidth_amplification(bits)
                == j_tpu.bitplane_bandwidth_amplification(bits))
    with pytest.raises(ValueError, match="positive"):
        tpu_gold.bitplane_bandwidth_amplification(0)


@pytest.mark.parametrize("schedule", ["linear", "binary-hopping", "tree",
                                      "rs-ag"])
def test_reduction_step_models_match(schedule):
    for p in (1, 2, 3, 8, 64, 100):
        assert reduction.steps_linear(p) == j_red.steps_linear(p)
        assert reduction.steps_binary_hopping(p) == j_red.steps_binary_hopping(p)
        assert reduction.movement_linear(p) == j_red.movement_linear(p)
        assert (reduction.movement_binary_hopping(p)
                == j_red.movement_binary_hopping(p))
        assert (reduction.collective_bytes_per_device(schedule, 4096.0, p)
                == j_red.collective_bytes_per_device(schedule, 4096.0, p))
        if schedule == "rs-ag":
            with pytest.raises(ValueError, match="unknown schedule"):
                reduction.reduction_latency_model(schedule, 32, p)
            continue
        for n in (8, 32):
            assert (reduction.reduction_latency_model(schedule, n, p, 2.0, 3.0)
                    == j_red.reduction_latency_model(schedule, n, p, 2.0, 3.0))


# ---------------------------------------------------------------------------
# the paper tables
# ---------------------------------------------------------------------------

TABLES = ["table1_frequency", "fig1_scaling", "table4_reduction",
          "table5_utilization", "fig5_scalability", "table8_systems",
          "fig7_gemv", "fig7_simulator_validation", "table9_curvefit"]


@pytest.mark.parametrize("table", TABLES)
def test_paper_table_rows_match_reference(table):
    want = getattr(j_tables, table)()
    fn = getattr(paper_tables, table)
    got = fn(CPU) if table == "fig7_simulator_validation" else fn()
    assert [(name, derived) for name, _, derived in got] == [
        (name, derived) for name, _, derived in want]
    assert all(us >= 0.0 for _, us, _ in got)


def test_paper_tables_cli_on_the_cpu(capsys):
    assert paper_tables.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# simulator on CPU; us_per_call is host wall time"
    assert out[1] == "name,us_per_call,derived"
    derived = {line.split(",")[0]: line.split(",", 2)[2] for line in out[2:]}
    assert len(derived) == len(out) - 2 == 144
    assert derived["table9/IMAGine"] == (
        "a=1.16;b=1.00;c=147.0;add=Standard;move=Standard;gold=True")
    assert derived["table8/IMAGine"] == (
        "clock=100.0%;bram=100.0%;bandwidth=100.0%;gold=True")
    assert derived["fig7sim/gemv_16x64"] == (
        "cycles=2116;analytic=2116;exact=True")
