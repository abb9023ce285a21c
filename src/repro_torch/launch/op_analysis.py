"""What one call of a step does, counted op by op: the counterpart of the
reference's ``launch/hlo_analysis.py`` (``analyze_hlo``,
``host_transfer_counts``), which reads XLA's HLO text.  PyTorch runs
eagerly, so :class:`OpCounter` watches the call itself, as a
``TorchDispatchMode`` (every aten operation) under a ``TorchFunctionMode``
(the tensor methods that read a value back to the host):

  * ``flops``     — the products outside the kernels (``mm``, ``addmm``,
                    ``bmm``, ``baddbmm``, the convolutions and their
                    backward: 2 M N K), plus each kernel entry's operations;
  * ``bytes``     — every operation's operands and results (views move
                    nothing), plus each kernel entry's bytes;
  * ``dtypes``    — the dtypes of every operand and result;
  * ``host_transfers`` — ``.item()``, ``.tolist()``, ``.numpy()``,
                    ``.cpu()``, ``float(t)``/``int(t)``/``bool(t)``, copies
                    to the CPU, and the operations that synchronize by their
                    nature (``nonzero``, boolean indexing, ``unique``, ...);
  * ``peak_live_bytes`` — the peak of the bytes that the call's new
                    tensors hold at once (its arguments excluded).

Each ``kernels/ops.py`` entry (and each kernel backward) counts as one
operation: its FLOPs and bytes come from ``launch/roofline.py``'s formula
for that kernel, not from the plain version's internals or the meta rule's
empty outputs, and the operations inside it are not counted.  On the card
the plain attention's (B, H, S, S) scores are not HBM traffic: the kernel
never writes them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Dict, Optional, Set

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import observe
from . import roofline

_aten = torch.ops.aten

#: the products whose FLOPs count (the reference's ``dot``/``convolution``),
#: by ``torch.utils.flop_counter``'s formulas
PRODUCTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm, _aten.convolution,
            _aten._convolution, _aten.convolution_backward}
#: the composite products that reach the counter undecomposed where autograd
#: is off (``torch.inference_mode``): 2 x each output element x its
#: contraction
COMPOSITE_PRODUCTS = {_aten.matmul, _aten.linear, _aten.einsum, _aten.conv1d, _aten.conv2d,
                      _aten.conv3d}

#: tensor methods that read a value back to the host
HOST_METHODS = {torch.Tensor.item: "item", torch.Tensor.tolist: "tolist",
                torch.Tensor.numpy: "numpy", torch.Tensor.cpu: "cpu",
                torch.Tensor.__array__: "numpy", torch.Tensor.__bool__: "bool",
                torch.Tensor.__float__: "float", torch.Tensor.__int__: "int",
                torch.Tensor.__index__: "index", torch.Tensor.__format__: "format",
                torch.Tensor.__repr__: "repr"}

#: aten operations that block the host on the device by their nature
SYNC_OPS = {_aten._local_scalar_dense: "item", _aten.nonzero: "nonzero",
            _aten.masked_select: "masked_select", _aten._unique2: "unique",
            _aten.unique_dim: "unique", _aten.unique_consecutive: "unique",
            _aten.equal: "equal", _aten.is_nonzero: "bool"}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements span: its distinct elements, so a
    broadcast view counts what it reads."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _composite_flops(packet, args, out) -> float:
    """2 x output elements x contraction length of a composite product."""
    if packet is _aten.einsum:
        equation, operands = args[0], args[1]
        if len(operands) < 2:
            return 0.0
        sizes = {}
        for term, t in zip(equation.split("->")[0].split(","), operands):
            sizes.update(zip(term.replace(" ", ""), t.shape))
        return 2.0 * math.prod(sizes.values())
    o = out if isinstance(out, torch.Tensor) else out[0]
    if packet in (_aten.matmul, _aten.linear):
        return 2.0 * o.numel() * args[0].shape[-1]
    w = args[1]                                   # conv{1,2,3}d: (Cout, Cin / groups, *k)
    return 2.0 * o.numel() * math.prod(w.shape[1:])


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def kernel_work(name: str, operands, config) -> roofline.Work:
    """The roofline work of one kernel entry from its operands (in
    ``kernels/observe.entry``'s order)."""
    if name == "tamper_verdict":
        ref, recv = operands
        n, d = ref.shape[-2:]
        return roofline.tamper_check_work(math.prod(ref.shape[:-2]), n, d, ref is recv,
                                          ref.element_size())
    if name in ("quant_roundtrip", "quant_roundtrip_stats"):
        (x,) = operands
        d = x.shape[-1]
        rows = x.numel() // d
        if name == "quant_roundtrip":
            return roofline.quant_dequant_work(rows, d)
        return roofline.quant_dequant_stats_work(rows, d, math.prod(x.shape[:-2]))
    if name in ("flash_attention", "flash_attention_bwd"):
        q, k, _ = operands
        b, sq, h, d = q.shape
        fn = (roofline.flash_attention_work if name == "flash_attention"
              else roofline.flash_attention_bwd_work)
        return fn(b, sq, k.shape[1], h, k.shape[2], d, config.get("window", 0),
                  config.get("causal", True), _dtype_name(q))
    if name in ("fused_xent", "fused_xent_bwd"):
        h2, w = operands
        fn = roofline.fused_xent_work if name == "fused_xent" else roofline.fused_xent_bwd_work
        return fn(h2.shape[0], h2.shape[1], w.shape[1], h2.element_size())
    if name == "decode_attention":
        q, k, _ = operands
        index = config.get("index")
        return roofline.decode_attention_work(
            q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3], config.get("window", 0),
            None if isinstance(index, torch.Tensor) else int(index), _dtype_name(q))
    if name == "decode_attention_partial":
        q, k, _ = operands
        index = config.get("index")
        return roofline.decode_attention_partial_work(
            q.shape[0], k.shape[1], q.shape[2], k.shape[2], q.shape[3], config["base"],
            config.get("window", 0), None if isinstance(index, torch.Tensor) else int(index),
            _dtype_name(q))
    if name == "slstm_scan":
        pre, _ = operands
        t, b, d4 = pre.shape
        return roofline.slstm_scan_work(t, b, d4 // 4, config["n_heads"], _dtype_name(pre))
    if name == "slstm_scan_bwd":
        dout, _ = operands
        t, b, d = dout.shape
        return roofline.slstm_scan_bwd_work(t, b, d, config["n_heads"])
    raise KeyError(f"no roofline work for kernel entry {name!r}")


@dataclasses.dataclass
class OpAnalysis:
    """What the counter saw in one call."""
    ops: int = 0                                  # aten operations outside kernel entries
    product_flops: float = 0.0                    # the products outside the kernels
    kernel_flops: float = 0.0
    bytes: float = 0.0                            # outside the kernels
    kernel_bytes: float = 0.0
    dtypes: Set[str] = dataclasses.field(default_factory=set)
    host_transfers: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)
    products: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def flops(self) -> float:
        return self.product_flops + self.kernel_flops

    @property
    def total_bytes(self) -> float:
        return self.bytes + self.kernel_bytes



class _HostReads(TorchFunctionMode):
    """The host reads at the tensor-method level."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = HOST_METHODS.get(func)
        if kind is None and func is torch.Tensor.to:
            kind = self.counter._to_host(args, kwargs)
        if kind is None or self.counter._in_kernel:
            return func(*args, **kwargs)
        if not (args and isinstance(args[0], torch.Tensor)
                and self.counter._is_host_made(args[0])):
            self.counter._host(kind)
        self.counter._reading += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.counter._reading -= 1


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn(*args)``, then ``c.result`` (an
    :class:`OpAnalysis`).  ``track_memory=False`` skips the live-bytes
    bookkeeping."""

    def __init__(self, track_memory: bool = True):
        super().__init__()
        self.result = OpAnalysis()
        self.track_memory = track_memory
        self._in_kernel = 0
        self._reading = 0
        self._live = 0
        self._storages: Dict[int, list] = {}
        self._host_made: Dict[int, weakref.ref] = {}
        self._host_mode = _HostReads(self)

    # -- installation -------------------------------------------------------

    def __enter__(self):
        observe.OBSERVERS.append(self)
        self._host_mode.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._host_mode.__exit__(*exc)
            observe.OBSERVERS.remove(self)

    @contextlib.contextmanager
    def kernel(self, name: str, operands, config):
        """A kernel entry (``kernels/observe.entry``): one operation of the
        kernel's roofline work; nothing inside it is counted."""
        r = self.result
        r.kernels[name] = r.kernels.get(name, 0) + 1
        work = kernel_work(name, operands, config)
        r.kernel_flops += work.ops
        r.kernel_bytes += work.bytes
        r.dtypes.update(_dtype_name(t) for t in operands if isinstance(t, torch.Tensor))
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1

    # -- counting -----------------------------------------------------------

    def _mark_host_made(self, t: torch.Tensor) -> None:
        key = id(t)
        self._host_made[key] = weakref.ref(t, lambda _, k=key: self._host_made.pop(k, None))

    def _is_host_made(self, t: torch.Tensor) -> bool:
        """A CPU tensor made from Python values inside the call
        (``float(torch.tensor(0.9, dtype=bf16))`` rounds a constant to a
        dtype), or computed from such tensors alone: reading it is no
        transfer.  Keyed by identity (a tensor's ``==`` is elementwise)."""
        ref = self._host_made.get(id(t))
        return ref is not None and ref() is t

    def _host(self, kind: str) -> None:
        t = self.result.host_transfers
        t[kind] = t.get(kind, 0) + 1

    @staticmethod
    def _to_host(args, kwargs) -> Optional[str]:
        """``Tensor.to`` that moves a device tensor to the CPU."""
        src = args[0]
        target = kwargs.get("device")
        for a in args[1:]:
            if isinstance(a, (str, torch.device)):
                target = a
        if target is None or src.device.type == "cpu":
            return None
        return "to_cpu" if torch.device(target).type == "cpu" else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if self.track_memory:
            self._track(ins, outs)
        packet = func.overloadpacket
        host_made = (packet in (_aten.lift_fresh, _aten.lift_fresh_copy, _aten.scalar_tensor)
                     or bool(ins) and all(self._is_host_made(t) for t in ins))
        if host_made:
            for t in outs:
                if t.device.type == "cpu":
                    self._mark_host_made(t)
        if self._in_kernel:
            return out
        r = self.result
        r.ops += 1
        r.dtypes.update(_dtype_name(t) for t in ins + outs)
        if packet in SYNC_OPS and not self._reading and not host_made:
            self._host(SYNC_OPS[packet])
        elif packet is _aten.index and any(t.dtype == torch.bool for t in ins[1:]):
            self._host("bool_index")
        elif packet in (_aten._to_copy, _aten.copy_):
            if outs and outs[0].device.type == "cpu" and any(
                    t.device.type != "cpu" for t in ins):
                self._host("to_cpu")
        if func.is_view:
            return out
        r.bytes += sum(_nbytes(t) for t in ins + outs)
        if packet in PRODUCTS or packet in COMPOSITE_PRODUCTS:
            if packet in PRODUCTS:
                from torch.utils.flop_counter import flop_registry
                flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
            else:
                flops = _composite_flops(packet, args, out)
            r.product_flops += flops
            r.products[packet.__name__] = r.products.get(packet.__name__, 0.0) + flops
        return out

    def _track(self, ins, outs) -> None:
        """Live bytes: a result on a storage no operand holds is new; its
        bytes stay live until the last tensor on it dies (autograd's saved
        tensors keep theirs alive)."""
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            key = t.untyped_storage()._cdata
            entry = self._storages.get(key)
            if entry is None:
                if key in seen:
                    continue
                entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
                self._live += entry[0]
                self.result.peak_live_bytes = max(self.result.peak_live_bytes, self._live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live -= entry[0]
            del self._storages[key]


__all__ = ["COMPOSITE_PRODUCTS", "HOST_METHODS", "OpAnalysis", "OpCounter", "PRODUCTS", "SYNC_OPS",
           "kernel_work"]
