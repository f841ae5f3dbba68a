"""The system under test: `repro_torch`'s continuous batcher, built the way
`repro_torch.launch.serve` builds it, on weights the benchmark draws.

This is the only module that imports the program. It takes from it the
batcher and its `Request`, the config class, the quantizing engine, the
kernel build, and the names of the calls it wraps in traced runs: the
batcher's admission and prefill step, and the kernel entry points.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import sys
from pathlib import Path
from typing import Callable, List

import torch

HERE = Path(__file__).resolve().parent


def load_family(name: str):
    """`bench/models/<name>.py`: a family's weight maker and reference."""
    path = HERE / "models" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.models.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class System:
    batcher: object
    request_cls: type
    n_slots: int
    table_width: int


def kernel_impl(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "ref"


def build(config: dict, traffic: dict, seed: int,
          device: torch.device) -> System:
    """Weights from `seed`, packed when the configuration serves bit-plane
    weights (the dense tree is dropped), the kernels built or loaded, and
    the batcher."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.quant.bitplane import PimQuantConfig
    from repro_torch.serve import ServeConfig, ServeEngine

    impl = kernel_impl(device)
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    model, serving = config["model"], config["serving"]
    cfg = ModelConfig(**model)
    params = load_family(config["family"]).make_params(model, seed, device)
    weights = serving["weights"]
    if weights["kind"] == "bitplane":
        eng = ServeEngine(cfg, params, ServeConfig(device=str(device),
                                                   kernel_impl=impl))
        del params
        eng.quantize(PimQuantConfig(n_bits=weights["n_bits"],
                                    group=weights["group"], impl=impl,
                                    min_features=1))
        params = eng.params
        del eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rebuild(config, traffic, params, device)


def rebuild(config: dict, traffic: dict, params,
            device: torch.device) -> System:
    """A batcher for the traffic on parameters already served."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve import ContinuousBatcher, Request

    serving = config["serving"]
    bs = int(serving["block_size"])
    cache_len = (int(traffic["prompt_tokens"]["max"])
                 + int(traffic["output_tokens"]["max"]))
    n_slots = int(traffic["slots"])
    impl = kernel_impl(device)
    batcher = ContinuousBatcher(
        ModelConfig(**config["model"]), params, n_slots=n_slots,
        cache_len=cache_len, paged=True, block_size=bs, prefix=True,
        eos_token=-1, kernel_impl=impl, bucket_strategy="pow2",
        kv_dtype=serving["kv_dtype"], device=device)
    return System(batcher, Request, n_slots, -(-cache_len // bs))


def warm(system: System, traffic: dict, vocab: int) -> None:
    """Run the cell's own step shapes once: a prefill at the longest and
    at the shortest prompt the mix sends, each followed by a decode of
    the whole slot batch. Warm-up requests use uids no traffic draws."""
    b = system.batcher
    for i, key in enumerate(("max", "min")):
        n = int(traffic["prompt_tokens"][key])
        prompt = torch.randint(0, vocab, (n,), generator=torch.Generator()
                               .manual_seed(i)).numpy().astype("int32")
        b.submit(system.request_cls(uid=-1 - i, prompt=prompt,
                                    max_new_tokens=2))
        b.run_until_drained()
    for i in (-1, -2):
        b.finished.pop(i, None)


# ---------------------------------------------------------------------------
# traced runs: the benchmark's own stamps and ranges around the program
# ---------------------------------------------------------------------------

def watch_batcher(batcher, clock: Callable[[], float], admits: dict):
    """Stamp each request's admission (the batcher seats it in a slot and
    starts its prefill) on `clock` into `admits[uid]`, and run every
    prefill step inside the range `bench/prefill`."""
    seat = batcher._prefill_into_paged
    step = batcher._prefill_paged

    def seated(i, req, *args):
        admits[req.uid] = clock()
        return seat(i, req, *args)

    def prefill(*args, **kw):
        with torch.profiler.record_function("bench/prefill"):
            return step(*args, **kw)
    batcher._prefill_into_paged = seated
    batcher._prefill_paged = prefill


#: range name -> (module, attribute) of each kernel entry point
ENTRY_POINTS = {
    "bench/k1": ("repro_torch.kernels.paged_attention", "paged_attention"),
    "bench/k2": ("repro_torch.kernels.paged_prefill", "paged_prefill"),
    "bench/k3": ("repro_torch.kernels.bitplane_gemv", "bitplane_gemv"),
    "bench/k4": ("repro_torch.kernels.bitplane_gemm", "bitplane_gemm"),
}


class Ranges:
    """Wraps each kernel entry point, wherever the program has bound it,
    in a profiler range of the benchmark's own; the bit-plane wrappers
    also note each call's rows, K and M (host shapes, no sync) while
    `recording` is set."""

    def __init__(self, calls: List[tuple]):
        self.calls = calls
        self.recording = False
        self._undo = []

    def _wrap(self, name, fn):
        bitplane = name in ("bench/k3", "bench/k4")

        @functools.wraps(fn)
        def ranged(*args, **kw):
            if bitplane and self.recording:
                x_r, planes = args[0], args[1]
                dpb, rows, k8 = x_r.shape
                self.calls.append((name, rows, k8 * dpb, planes.shape[-1]))
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return ranged

    def install(self):
        for name, (mod_name, attr) in ENTRY_POINTS.items():
            orig = getattr(importlib.import_module(mod_name), attr)
            wrapped = self._wrap(name, orig)
            for mod in list(sys.modules.values()):
                if not getattr(mod, "__name__", "").startswith("repro_torch"):
                    continue
                for key, val in list(vars(mod).items()):
                    if val is orig:
                        setattr(mod, key, wrapped)
                        self._undo.append((mod, key, orig))

    def remove(self):
        for mod, key, orig in reversed(self._undo):
            setattr(mod, key, orig)
        self._undo.clear()
