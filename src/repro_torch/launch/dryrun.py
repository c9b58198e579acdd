"""What the port's dry run reads and counts: the card's data-sheet figures,
the record's collective bytes, and the per-rank tally of a traced cell.

The counterpart of the parts of ``repro.launch.dryrun`` that
``launch/kmeans_dryrun.py`` imports (the LM cells wait for the LM stack).
The reference compiles each cell for 512 fake TPU devices and reads XLA's
cost and memory analysis; here a cell runs as rank 0 of a fake world
(``distributed/world.fake``) on fake CUDA tensors (``FakeTensorMode``),
which hold no memory and launch nothing, and :class:`Tally` counts what
the rank would do:

* ``flops``: ``FlopCounterMode``'s count of the eager ops (matrix
  products), plus each kernel launch's ``work`` (``kernels/work.py``);
* ``bytes_accessed``: every aten op that is not a view or an alias, a
  metadata query, an allocation or a collective adds the bytes of its
  operands and results on the card (the
  unfused eager count the port executes: each op reads its inputs from and
  writes its outputs to device memory), plus each launch's ``work``;
* ``argument_size_in_bytes``: the cell's inputs on the card, and what it
  copies there from the host; ``output_size_in_bytes``: its outputs on the
  card; ``temp_size_in_bytes``: the peak of the bytes live on the card
  (storages alive at once, inputs included; the kernels' own workspaces
  other than the whole solve's are not counted);
* the collectives from ``distributed/comm.py``'s counts, by kind with each
  call's result bytes (:func:`collective_bytes`), and by stage with the
  bytes the rank hands in.

A loop counts one trip, as XLA's cost analysis counts a loop body once.
"""
from __future__ import annotations

import contextlib
import numbers
import weakref
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.distributed import comm
from repro_torch.kernels import work

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# One NVIDIA H100 SXM5 80GB at its 700 W limit, from NVIDIA's data sheet:
# figures of the part, not measurements.  The f32 paths run IEEE fused
# multiply-adds on the CUDA cores (no tensor cores), so the f32 peak.
PEAK_FLOPS = 67e12           # f32 FLOP/s without the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
# Collectives that span more than one node of 8 cards run over the
# node's network: one 400 Gb/s NDR InfiniBand port a GPU (the DGX H100's
# ConnectX-7 a GPU) = 50e9 bytes/s each way.  Inside a node NVLink gives
# 450e9 bytes/s each way; every mesh of the dry run spans many nodes.
LINK_BW = 50e9

# ops that only allocate: their results are live, but no byte is moved
_ALLOC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
          torch.ops.aten.empty_like, torch.ops.aten.new_empty,
          torch.ops.aten.new_empty_strided}


def collective_bytes() -> dict:
    """The collectives since ``comm.reset()`` by kind: ``{kind: result
    bytes, ..., "_counts": {kind: calls}}``, the reference's
    ``collective_bytes`` of an HLO text (there, each op's result shape;
    an all-gather's is the group size times its input)."""
    out = {kind: c["bytes"] for kind, c in comm.kinds.items()}
    out["_counts"] = {kind: c["calls"] for kind, c in comm.kinds.items()}
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(values) -> list:
    """The tensors among ``values`` and in their lists and tuples (an aten
    op's arguments and results nest no deeper)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type != "cpu"


class Tally:
    """One rank's counts of a traced cell (the module docstring says what
    each one is).  ``launches`` counts the shape-only kernel launches by
    kernel name."""

    def __init__(self):
        self.eager_flops = 0
        self.kernel_flops = 0.0
        self.bytes = 0.0
        self.arguments = 0
        self.live = 0
        self.peak = 0
        self.launches: dict[str, int] = {}
        self._alive: set[int] = set()

    @property
    def flops(self) -> float:
        return float(self.eager_flops) + self.kernel_flops

    def kernel(self, name: str, w: work.Work) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        self.kernel_flops += w.flops
        self.bytes += w.bytes

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live on the card until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return
        nb = st.nbytes()
        self._alive.add(key)
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nb)

    def _free(self, key: int, nb: int) -> None:
        self._alive.discard(key)
        self.live -= nb

    def argument(self, *tensors) -> None:
        """The cell's inputs on the card."""
        for t in tree_leaves(tensors):
            if _on_card(t):
                self.arguments += _nbytes(t)
                self.hold(t)

    def op(self, func, args, kwargs, out) -> None:
        results = _tensors((out,))
        outs = [t for t in results if _on_card(t)]
        ins = _tensors(args) + _tensors(kwargs.values())
        if (func is torch.ops.aten._to_copy.default and outs and ins
                and not _on_card(ins[0])):
            self.arguments += sum(map(_nbytes, outs))    # host -> card
        # metadata queries (no tensor result), views, collectives
        if (not results or func.is_view
                or func.namespace in ("c10d", "_c10d_functional")):
            return
        stores = [t.untyped_storage() for t in ins]
        if not func._schema.is_mutable and all(
                any(t.untyped_storage() is st for st in stores)
                for t in results):
            return                                       # an alias
        for t in outs:
            self.hold(t)
        if func.overloadpacket in _ALLOC:
            return
        self.bytes += sum(_nbytes(t) for t in ins if _on_card(t))
        self.bytes += sum(map(_nbytes, outs))


class _Counter(TorchDispatchMode):
    def __init__(self, tally: Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tally.op(func, args, kwargs, out)
        return out


def _index(x: torch.Tensor, index):
    """``x[index]`` from aten ops -> ``(basic view, advanced indices or
    None)``: ints, slices, ``None`` and ``...`` as views, then the tensor
    indices in ``aten.index``'s form (a slot per dimension of the view)."""
    index = index if isinstance(index, tuple) else (index,)
    used = sum(i.dim() if isinstance(i, torch.Tensor) and i.dtype == torch.bool
               else 1 for i in index if i is not None and i is not Ellipsis)
    out, dim, adv = x, 0, {}
    for i in index:
        if i is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif i is Ellipsis:
            dim += x.dim() - used
        elif isinstance(i, slice):
            if i.step not in (None, 1):
                raise NotImplementedError("the dry run's indexing takes "
                                          "slices of step 1")
            out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop)
            dim += 1
        elif isinstance(i, numbers.Integral) and not isinstance(i, bool):
            out = out.select(dim, int(i))
        else:
            t = i if isinstance(i, torch.Tensor) else torch.as_tensor(
                i, device=x.device)
            adv[dim] = t
            dim += t.dim() if t.dtype == torch.bool else 1
    if not adv:
        return out, None
    slots = [adv.get(j) for j in range(max(adv) + 1)]
    return out, slots


def _getitem(x, index):
    view, slots = _index(x, index)
    return view if slots is None else torch.ops.aten.index.Tensor(view, slots)


def _setitem(x, index, value):
    view, slots = _index(x, index)
    if not isinstance(value, torch.Tensor):
        value = torch.full((), value, dtype=x.dtype, device=x.device)
    if slots is None:
        torch.ops.aten.copy_.default(view, value)
    else:
        torch.ops.aten.index_put_.default(view, slots, value.to(x.dtype))


def _to(x, *args, **kwargs):
    device, dtype, _, _ = torch._C._nn._parse_to(*args, **kwargs)
    if device is not None and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    if (dtype in (None, x.dtype)) and (device in (None, x.device)):
        return x
    return torch.ops.aten._to_copy.default(x, dtype=dtype or x.dtype,
                                           device=device or x.device)


def _contiguous(x, memory_format=torch.contiguous_format):
    if x.is_contiguous(memory_format=memory_format):
        return x
    return torch.ops.aten.clone.default(x, memory_format=memory_format)


# Tensor methods whose Python bindings take a device guard of the tensor's
# device, and the aten ops they come down to
_METHODS = {torch._C.TensorBase.__getitem__: _getitem,
            torch._C.TensorBase.__setitem__: _setitem,
            torch._C.TensorBase.copy_: torch.ops.aten.copy_.default,
            torch._C.TensorBase.to: _to,
            torch._C.TensorBase.contiguous: _contiguous,
            torch._C.TensorBase.__invert__: torch.bitwise_not}


class _FakeMethods(TorchFunctionMode):
    """Indexing, ``copy_``, ``to``, ``contiguous`` and ``~`` of fake
    tensors through aten ops.
    PyTorch built without CUDA refuses these on a fake CUDA tensor (their
    Python bindings take a device guard of the tensor's device), though
    every aten op they come down to runs on one; the dry run takes this way
    on every host, so its counts do not depend on the build."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        method = _METHODS.get(func)
        if method is not None and work.is_fake(args[0]):
            return method(*args, **kwargs)
        return func(*args, **kwargs)


@contextlib.contextmanager
def traced(tally: Tally):
    """Fake CUDA tensors, the kernels' shape-only routes and ``tally``
    counting them, for the block.  Fake tensors made outside the block stay
    fake; real ones given to an op inside are taken as fake copies."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    flops = FlopCounterMode(display=False)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), flops, \
                _Counter(tally), _FakeMethods(), work.tally(tally.kernel):
            yield tally
    finally:
        tally.eager_flops = flops.get_total_flops()
