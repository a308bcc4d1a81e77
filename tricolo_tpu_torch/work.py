"""Per-op work counts: the FLOPs, bytes and compute class of every aten op
and every port-kernel call a block runs.

The port's counterpart of the XLA cost analysis that the JAX package's
``scripts/roofline_report.py`` reads (its per-op ``bytes_accessed`` and
``model_flops``), which a ``torch.profiler`` trace does not carry:

    with WorkCounter() as counter:
        step(batch, lr)
    counter.write("work.json", card)

``WorkCounter`` is a ``TorchDispatchMode``. For each aten op it dispatches
it records

* **FLOPs** from ``torch.utils.flop_counter``'s registered formulas, and
  for the cuDNN RNN (``_cudnn_rnn`` and its backward), which torch leaves
  uncounted, ``rnn_flops``: 2·B·G·H·(I + H) a time step, a direction and a
  layer forward (G gates: 3 for the GRU), twice that backward; 0 for any
  other op. An op without a formula that decomposes is counted through its
  decomposition, as ``FlopCounterMode`` counts it, so the two agree;
* **bytes**, XLA's "bytes accessed": every distinct tensor argument and
  result (by identity) once, each at the extent of the view itself —
  numel × element size over its dimensions with a nonzero stride, never
  its storage. View and alias ops and the factories that write nothing
  (``ZERO_BYTE_OPS``, any op whose schema marks it a view) count 0; an op
  that writes (``zeros``, ``fill_``, ``copy_``) counts what it touches; an
  in-place op counts its tensor once. A gather (``GATHER_OPS``) reads its
  source only where it gathers (``gathered_bytes``: the rows of its
  distinct index values, what this data needs); a ``*_like`` or ``new_*``
  factory reads nothing of its template;
* **the compute class** (``PEAK_FLOPS``): ``bf16`` (bf16/fp16 on the
  tensor cores), ``tf32`` (an f32 matrix product or convolution while
  ``torch.backends.cuda.matmul.allow_tf32`` / ``torch.backends.cudnn.
  allow_tf32`` allows TF32), ``f32``, or ``memory`` (no FLOPs).

Each op runs inside ``torch.profiler.record_function(f"work#{i}")``, so a
trace links the op's device work to its record (``roofline_report``).

The port's kernels are launched through ctypes and dispatch no aten op.
Each wrapper opens ``launch(wrapper_name, work_fn, *args)`` around its
launch: with no counter active that is one module-level check; with one,
it records the call under its K-label (``LABELS``) with the (bytes, flops)
of the kernel module's ``work(...)`` — the count ``chip_smoke.py``'s phase
3 bounds use — inside a ``work#{i}:K<n>`` range.

The record (``write``) is JSON: ``{"card": ..., "ops": [[id, op, class,
flops, bytes], ...], "kernel_args": {id: [work module, its arguments]}}``,
ids in dispatch order.
"""

from __future__ import annotations

import contextlib
import json
import threading
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# H100 SXM data sheet, dense: FLOP/s by compute class, and HBM bytes/s.
PEAK_FLOPS = {"bf16": 989e12, "tf32": 494e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
# Ops that read and write nothing their schema does not mark as a view.
ZERO_BYTE_OPS = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "as_strided",
    "view", "permute", "t", "detach", "_unsafe_view", "alias", "lift_fresh",
    "_reshape_alias", "expand", "record_stream", "set_", "resize_",
})
# Ops that read their first argument (the source) only where they gather.
GATHER_OPS = frozenset({"gather", "index", "index_select", "embedding", "take"})
# Matrix products whose f32 form TF32 may run (the cuBLAS flag); the
# convolutions and the cuDNN RNN follow the cuDNN flag.
MATMUL_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm"})
CUDNN_OPS = frozenset({"convolution", "_convolution", "cudnn_convolution",
                       "convolution_backward", "_cudnn_rnn", "_cudnn_rnn_backward"})
# Port kernel wrappers → their labels in the records and the reports.
LABELS = {
    "bn_relu_pool": "K1", "bn_relu_pool_unmasked": "K1-unmasked",
    "scatter_tiles_ps": "K2", "scatter_tiles_global": "K2-global",
    "bn_relu_pool_bwd": "K3", "bn_relu_pool_bwd_unmasked": "K3-unmasked",
    "nt_xent_fwd": "K4", "nt_xent_fwd_pair": "K4-pair", "nt_xent_bwd_rows": "K5",
    "nt_xent_bwd_cols": "K6", "nt_xent_bwd": "K5-K6", "gather_tiles": "K7",
    "conv3d_valid_dgrad": "K8", "conv3d_valid_wgrad": "K9",
}
# Port kernels whose FLOPs run on the tensor cores in bf16; the others' run
# outside them in f32.
TENSOR_CORE_LABELS = frozenset({"K8", "K9"})
_GATES = {0: 1, 1: 1, 2: 4, 3: 3}  # cuDNN RNN modes: RNN_RELU, RNN_TANH, LSTM, GRU


def rnn_flops(input, weight, weight_stride0, weight_buf, hx, cx, mode, hidden_size,
              proj_size, num_layers, batch_first, dropout, train, bidirectional,
              batch_sizes, *rest, **kwargs) -> int:
    """FLOPs of ``aten::_cudnn_rnn``: 2·rows·G·H·(I_l + H) a direction and
    layer, rows = time steps × batch (a packed input's row count), I_l the
    input width of layer l (H·directions past the first)."""
    rows = input.shape[0] if batch_sizes else input.shape[0] * input.shape[1]
    dirs = 2 if bidirectional else 1
    total = 0
    for layer in range(num_layers):
        width = input.shape[-1] if layer == 0 else hidden_size * dirs
        total += 2 * rows * _GATES[mode] * hidden_size * (width + hidden_size) * dirs
    return total


def rnn_backward_flops(input, weight, weight_stride0, weight_buf, hx, cx, output,
                       grad_output, grad_hy, grad_cy, mode, hidden_size, proj_size,
                       num_layers, batch_first, dropout, train, bidirectional, batch_sizes,
                       *rest, **kwargs) -> int:
    """Twice the forward's: the input and the weight gradients."""
    return 2 * rnn_flops(input, weight, weight_stride0, weight_buf, hx, cx, mode, hidden_size,
                         proj_size, num_layers, batch_first, dropout, train, bidirectional,
                         batch_sizes)


def _raw(formula):
    """A ``flop_registry`` formula in this module's calling convention."""
    return lambda args, kwargs, out: formula(*args, **kwargs, out_val=out)


FLOP_FORMULAS = {packet: _raw(f) for packet, f in flop_registry.items()}
FLOP_FORMULAS[aten._cudnn_rnn] = lambda args, kwargs, out: rnn_flops(*args, **kwargs)
FLOP_FORMULAS[aten._cudnn_rnn_backward] = (
    lambda args, kwargs, out: rnn_backward_flops(*args, **kwargs))


def extent_bytes(t: torch.Tensor) -> int:
    """Bytes of the view ``t`` itself: its element size times the product
    of its sizes over the dimensions with a nonzero stride (a broadcast
    dimension reads one element)."""
    if t.layout != torch.strided:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def tensor_bytes(*trees) -> int:
    """Bytes of the distinct tensors (by identity) in ``trees``."""
    seen: dict[int, int] = {}
    for tree in trees:
        for leaf in tree_flatten(tree)[0]:
            if isinstance(leaf, torch.Tensor) and id(leaf) not in seen:
                seen[id(leaf)] = extent_bytes(leaf)
    return sum(seen.values())


def _index_tensor(name: str, args):
    """The one integer index tensor of a gather, or None."""
    if name == "index":
        tensors = [t for t in args[1] if t is not None]
        index = tensors[0] if len(tensors) == 1 else None
    else:
        index = {"index_select": 2, "embedding": 1, "take": 1}.get(name)
        index = args[index] if index is not None and len(args) > index else None
    if not isinstance(index, torch.Tensor) or index.dtype == torch.bool \
            or index.is_floating_point():
        return None
    return index


def gathered_bytes(name: str, args, out: torch.Tensor) -> int:
    """Bytes a gather reads from its source: for one integer index tensor,
    the rows of its distinct values (a repeated index reads its row once),
    counted outside any dispatch mode; else its result's extent."""
    from torch.utils._python_dispatch import _disable_current_modes

    index = _index_tensor(name, args)
    if index is None or index.numel() == 0:
        return extent_bytes(out)
    with _disable_current_modes():
        distinct = torch.unique(index).numel()
    return extent_bytes(out) // index.numel() * distinct


def compute_class(name: str, flops: int, args) -> str:
    """The class of an op from its FLOPs, its first floating tensor's dtype
    and device, and the TF32 flags of this moment (TF32 on CUDA only)."""
    if flops == 0:
        return "memory"
    first = next((t for t in tree_flatten(args)[0]
                  if isinstance(t, torch.Tensor) and t.is_floating_point()), None)
    if first is not None and first.dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if first is None or first.device.type != "cuda":
        return "f32"
    if name in MATMUL_OPS and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    if name in CUDNN_OPS and torch.backends.cudnn.allow_tf32:
        return "tf32"
    return "f32"


def floor_s(nbytes: float, flops: float, cls: str) -> float:
    """The least time for the work on the card: max(bytes / HBM, flops /
    the class's peak)."""
    t_flops = flops / PEAK_FLOPS[cls] if flops else 0.0
    return max(nbytes / HBM_BYTES_PER_S, t_flops)


_ACTIVE: WorkCounter | None = None
_NULL = contextlib.nullcontext()


def launch(wrapper: str, work_fn: Callable, *args):
    """The context a kernel wrapper opens around its launch: a no-op unless
    a ``WorkCounter`` is active; then the call's record under the wrapper's
    label, with (bytes, flops) = ``work_fn(*args)`` (a callable argument is
    called first: a count taken only while recording) and those arguments,
    and its ``work#{i}:K<n>`` range."""
    counter = _ACTIVE
    if counter is None:
        return _NULL
    args = tuple(a() if callable(a) else a for a in args)
    return counter.kernel(LABELS[wrapper], work_fn, args)


def valid_ids(ids: torch.Tensor, limit: int) -> int:
    """How many of ``ids`` lie in [0, ``limit``), counted outside any
    active dispatch mode (the count is the recorder's, not the step's)."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return int(((ids >= 0) & (ids < limit)).sum())


class WorkCounter(TorchDispatchMode):
    """Records every aten op dispatched and every port-kernel call made
    while it is active (module docstring); ``records`` holds [id, op,
    class, flops, bytes] in dispatch order. One counter at a time."""

    def __init__(self):
        super().__init__()
        self.records: list[list] = []
        self.kernel_args: dict[int, list] = {}
        self._lock = threading.Lock()
        self._depth = 0  # a decomposition re-enters the mode

    def _record(self, op: str, cls: str, flops: int, nbytes: int) -> int:
        with self._lock:
            i = len(self.records)
            self.records.append([i, op, cls, int(flops), int(nbytes)])
        return i

    def __enter__(self):
        global _ACTIVE
        if _ACTIVE is not None and _ACTIVE is not self:
            raise RuntimeError("a WorkCounter is already active")
        _ACTIVE = self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _ACTIVE
        self._depth -= 1
        if self._depth == 0:
            _ACTIVE = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "profiler":  # the ranges' own ops
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            # As FlopCounterMode: an op with an implicit decomposition is
            # counted as the ops it decomposes into.
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        packet = func._overloadpacket
        name = packet.__name__
        if func.is_view or name in ZERO_BYTE_OPS:
            i = self._record(f"aten::{name}", "memory", 0, 0)
            with torch.profiler.record_function(f"work#{i}"):
                return func(*args, **kwargs)
        with self._lock:
            i = len(self.records)
            self.records.append(None)
        with torch.profiler.record_function(f"work#{i}"):
            out = func(*args, **kwargs)
        formula = FLOP_FORMULAS.get(packet)
        flops = formula(args, kwargs, out) if formula is not None else 0
        if name.endswith("_like") or name.startswith("new_"):
            nbytes = tensor_bytes(args[1:], kwargs, out)  # the template is not read
        elif name in GATHER_OPS and isinstance(out, torch.Tensor):
            nbytes = tensor_bytes(args[1:], kwargs, out) + gathered_bytes(name, args, out)
        else:
            nbytes = tensor_bytes(args, kwargs, out)
        self.records[i] = [i, f"aten::{name}", compute_class(name, flops, (args, kwargs)),
                           int(flops), nbytes]
        return out

    def kernel(self, label: str, work_fn: Callable, args: tuple):
        """The record and range of one port-kernel call, (bytes, flops) =
        ``work_fn(*args)`` (when it counts FLOPs, class bf16 for
        ``TENSOR_CORE_LABELS``, else f32: the NT-Xent kernels run outside
        the tensor cores); ``kernel_args`` keeps the work function's module
        and arguments."""
        nbytes, flops = work_fn(*args)
        cls = ("bf16" if label in TENSOR_CORE_LABELS else "f32") if flops else "memory"
        i = self._record(label, cls, flops, nbytes)
        self.kernel_args[i] = [work_fn.__module__, [list(a) if isinstance(a, tuple) else a
                                                    for a in args]]
        return torch.profiler.record_function(f"work#{i}:{label}")

    def write(self, path, card: str) -> None:
        with open(path, "w") as f:
            json.dump({"card": card, "ops": self.records,
                       "kernel_args": {str(i): v for i, v in self.kernel_args.items()}}, f)


def load(path) -> dict:
    """A record written by ``WorkCounter.write``: {"card", "ops": {id: (op,
    class, flops, bytes)}, "kernel_args": {id: [work module, arguments]}}."""
    with open(path) as f:
        raw = json.load(f)
    return {"card": raw["card"],
            "ops": {i: (op, cls, flops, nbytes) for i, op, cls, flops, nbytes in raw["ops"]},
            "kernel_args": {int(i): v for i, v in raw.get("kernel_args", {}).items()}}

