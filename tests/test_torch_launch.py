"""The port's shared launch path (``ops/kernel_loader.py``) and the norm
wrappers' checks, on the CPU, with a stand-in for a built library.

A wrapper given CUDA tensors launches its kernel or raises; ``meta``
tensors take the same branch (only CPU tensors take the plain versions),
so they drive the checks here without a card.  The stand-in records
every entry-point call and every name looked up on it.
"""

import ctypes

import pytest
import torch

from deepspeed_tpu_torch.ops import kernel_loader as KL
from deepspeed_tpu_torch.ops import normalization as N


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(1)


class StandInLib:
    """Each entry point returns ``errors.get(name, 0)`` and records its
    arguments; ``lookups`` lists every attribute read."""

    def __init__(self, errors=None):
        self.calls, self.lookups = [], []
        self.errors = dict(errors or {})

    def __getattr__(self, name):
        self.lookups.append(name)
        if name == "ds_error_string":
            return lambda err: f"stand-in error {err}".encode()

        def fn(*args):
            self.calls.append((name, args))
            return self.errors.get(name, 0)
        return fn


def _kernel(lib):
    k = KL.CudaKernel("rmsnorm.cu", {"one": [KL.P, KL.I],
                                     "two": [KL.P, KL.F, KL.P]})
    k._lib = lib
    return k


def test_launch_calls_the_bound_function_with_its_arguments():
    lib = StandInLib()
    k = _kernel(lib)
    k.launch("one", 7, 8)
    k.launch("two", 9, 0.5, 10)
    assert lib.calls == [("one", (7, 8)), ("two", (9, 0.5, 10))]
    assert k.launches_by_fn == {"one": 1, "two": 1} and k.launches == 2


def test_launch_binds_each_entry_point_once():
    lib = StandInLib()
    k = _kernel(lib)
    for _ in range(5):
        k.launch("one", 1, 2)
        k.launch("two", 1, 1.0, 2)
    assert lib.lookups.count("one") == 1 and lib.lookups.count("two") == 1
    assert k.launches == 10
    k.reset_counts()
    assert k.launches == 0 and k.launches_by_fn == {"one": 0, "two": 0}
    k.launch("one", 1, 2)                # counting again, still bound
    assert lib.lookups.count("one") == 1 and k.launches == 1


def test_launch_raises_with_the_error_string_and_counts_only_successes():
    lib = StandInLib(errors={"two": 700})
    k = _kernel(lib)
    k.launch("one", 1, 2)
    with pytest.raises(RuntimeError,
                       match=r"rmsnorm\.two: CUDA error 700: stand-in "
                             r"error 700"):
        k.launch("two", 1, 1.0, 2)
    assert k.launches_by_fn == {"one": 1, "two": 0} and k.launches == 1
    lib.errors.clear()
    k.launch("two", 1, 1.0, 2)
    assert k.launches_by_fn == {"one": 1, "two": 1}


def test_bound_functions_get_the_declared_ctypes_signature():
    lib = StandInLib()
    k = _kernel(lib)
    k.lib()
    assert k._bound["two"].argtypes == [ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_void_p]
    assert k._bound["one"].restype is ctypes.c_int


def test_stream_of_reads_the_current_stream_at_every_call(monkeypatch):
    """The raw handle of the device's current stream, asked for at every
    launch (never cached): under ``torch.cuda.stream(side)`` or a graph
    capture the current stream changes between two launches."""
    current = {"handle": 11}
    asked = []

    def raw_stream(index):
        asked.append(index)
        return current["handle"]

    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    t = torch.empty(4, device="meta")
    assert KL.stream_of(t) == 11
    current["handle"] = 22
    assert KL.stream_of(t) == 22
    assert asked == [t.get_device()] * 2


@pytest.fixture
def stand_in_norms(monkeypatch):
    """Both norm libraries replaced by one stand-in, counts at zero, and a
    fixed stream handle (meta tensors have no stream)."""
    lib = StandInLib()
    for k in (N.KERNEL, N.LN_KERNEL):
        monkeypatch.setattr(k, "_lib", lib)
        monkeypatch.setattr(k, "_bound", {})
        monkeypatch.setattr(k, "launches_by_fn",
                            dict.fromkeys(k.functions, 0))
    monkeypatch.setattr(N, "stream_of", lambda t: 4321)
    return lib


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, device="meta", dtype=dtype)


def _call(wrapper, x, w, r=None):
    if wrapper == "rmsnorm":
        return N.rmsnorm(x, w, 1e-5)
    if wrapper == "rmsnorm_res":
        return N.rmsnorm(x, w, 1e-5, residual=_meta(x.shape)
                         if r is None else r)
    return N.layernorm(x, w, w if w.dtype == torch.float32
                       else _meta(w.shape, torch.float32), 1e-5)


E = 64
# operands each wrapper must refuse before launching: (x, weight,
# residual or None, the error, a fragment of its message)
REFUSED = {
    "fp32_activations": (lambda: _meta((4, E), torch.float32),
                         lambda: _meta((E,), torch.float32), None,
                         TypeError, "bf16 activations"),
    "fp32_residual": (lambda: _meta((4, E)),
                      lambda: _meta((E,), torch.float32),
                      lambda: _meta((4, E), torch.float32),
                      TypeError, "bf16 activations"),
    "bf16_weight": (lambda: _meta((4, E)), lambda: _meta((E,)), None,
                    ValueError, "fp32 \\[E\\] vectors"),
    "weight_of_E_plus_8": (lambda: _meta((4, E)),
                           lambda: _meta((E + 8,), torch.float32), None,
                           ValueError, "fp32 \\[E\\] vectors"),
    "non_contiguous_x": (lambda: _meta((E, 4)).t(),
                         lambda: _meta((E,), torch.float32), None,
                         ValueError, "contiguous activations"),
    "E_not_a_multiple_of_8": (lambda: _meta((4, 100)),
                              lambda: _meta((100,), torch.float32), None,
                              ValueError, "E % 8 == 0"),
    "E_above_8192": (lambda: _meta((4, 8200)),
                     lambda: _meta((8200,), torch.float32), None,
                     ValueError, "E <= 8192"),
}
REFUSED_CASES = [(case, wrapper) for case in REFUSED
                 for wrapper in ("rmsnorm", "rmsnorm_res", "layernorm")
                 if case != "fp32_residual" or wrapper == "rmsnorm_res"]


@pytest.mark.parametrize("case,wrapper", REFUSED_CASES,
                         ids=[f"{c}-{w}" for c, w in REFUSED_CASES])
def test_norm_wrappers_refuse_before_any_launch(stand_in_norms, case,
                                                wrapper):
    x, w, r, err, msg = REFUSED[case]
    with pytest.raises(err, match=msg):
        _call(wrapper, x(), w(), r() if r else None)
    assert stand_in_norms.calls == []
    assert N.KERNEL.launches == 0 and N.LN_KERNEL.launches == 0


def test_norm_wrappers_launch_once_with_rows_width_and_eps(stand_in_norms):
    """Accepted operands launch once each, with N = every row of a 3-D x,
    E, eps as given and the wrapper's one output allocation."""
    x, w = _meta((2, 3, E)), _meta((E,), torch.float32)
    out = N.rmsnorm(x, w, 1e-5)
    out2, res = N.rmsnorm(x, w, 1e-6, residual=_meta((2, 3, E)))
    out3 = N.layernorm(x, w, _meta((E,), torch.float32), 1e-5)
    assert [(name, args[-4:]) for name, args in stand_in_norms.calls] == [
        ("rmsnorm_bf16", (6, E, 1e-5, 4321)),
        ("rmsnorm_res_bf16", (6, E, 1e-6, 4321)),
        ("layernorm_bf16", (6, E, 1e-5, 4321))]
    for o in (out, out2, res, out3):
        assert o.shape == x.shape and o.dtype == torch.bfloat16
    assert N.KERNEL.launches_by_fn == {"rmsnorm_bf16": 1,
                                       "rmsnorm_res_bf16": 1}
    assert N.LN_KERNEL.launches == 1
    # no rows, no launch
    N.rmsnorm(_meta((0, E)), w)
    assert len(stand_in_norms.calls) == 3
