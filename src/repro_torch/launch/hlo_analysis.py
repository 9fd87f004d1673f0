"""Per-device work of one step over DTensors, for the roofline report: the
counterpart of ``repro.launch.hlo_analysis``.

Torch has no HLO. The reference walks XLA's partitioned HLO text, whose
shapes are per device; this module reads the same two quantities from the
ops one rank runs. ``Analysis`` is a ``TorchDispatchMode`` that lets every
op on DTensors through to DTensor's own dispatch (by returning
``NotImplemented``, as ``torch.distributed.tensor.debug.CommDebugMode``
does), and so sees the ops DTensor then runs on the rank's local shards,
after its sharding propagation and redistribution:

  * dot FLOPs: each op of the matmul family (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``_scaled_mm``, the fused attention ops; ``einsum`` and
    ``matmul`` reach the dispatcher as these), by
    ``torch.utils.flop_counter``'s registered formula on the shapes of its
    local operands. The registry's convolutions are left out, as the
    reference counts dots only. A product that is replicated counts its
    whole size on every rank; dividing a logical count by the rank count
    would not;
  * collective bytes by the reference's five kinds, summed over the result
    sizes of the functional collectives run on local tensors.

A mesh on ``cpu`` has no all-to-all: DTensor's ``shard_dim_alltoall`` falls
back there to an all-gather and a chunk. While an ``Analysis`` is active
that function is wrapped, so that the exchange counts as one all-to-all of
the local input's bytes (what NCCL's ``all_to_all_single`` returns) and the
all-gather inside it counts nothing.

``unparsed_whiles`` is always 0: the port's layer stacks are Python loops,
run unrolled, so there is no trip count to guess.
"""
from __future__ import annotations

import sys
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op-name fragments of each kind, matched against the functional
#: collectives' names (``_c10d_functional.all_gather_into_tensor``, ...);
#: DTensor's redistributions use no collective-permute, which stays 0
_KIND_OF = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"))

_NOT_DOTS = ("conv",)


def _is_dot(packet) -> bool:
    return packet in flop_registry and not any(n in str(packet) for n in _NOT_DOTS)


def _collective_kind(func) -> str | None:
    name = func.name()
    if "c10d" not in name:
        return None
    return next((kind for frag, kind in _KIND_OF if frag in name), None)


def _bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(t) for t in tree)
    return 0


class Analysis(TorchDispatchMode):
    """Counts, while active, the dot FLOPs and collective bytes of the ops
    this rank runs (module docstring). Plain tensors count as they are, so on
    a one-rank mesh, or without one, the count is the whole step's."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.collectives: dict[str, float] = defaultdict(float)
        self._quiet = 0
        self._depth = 0   # the mode re-enters itself to decompose an op
        self._patched: list = []

    def __enter__(self):
        if not self._depth:
            self._wrap_alltoall()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if not self._depth:
                for mod, fn in self._patched:
                    mod.shard_dim_alltoall = fn
                self._patched = []

    def _wrap_alltoall(self):
        """Wrap ``shard_dim_alltoall`` in every DTensor module that holds it
        (``placement_types`` imports it by name)."""
        from torch.distributed.tensor import _collective_utils
        orig = _collective_utils.shard_dim_alltoall

        def counted(input, *args, **kwargs):
            if not self._quiet:
                self.collectives["all-to-all"] += _bytes(input)
            self._quiet += 1
            try:
                return orig(input, *args, **kwargs)
            finally:
                self._quiet -= 1

        for name, mod in list(sys.modules.items()):
            if (name.startswith("torch.distributed.tensor")
                    and getattr(mod, "shard_dim_alltoall", None) is orig):
                self._patched.append((mod, orig))
                mod.shard_dim_alltoall = counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # DTensor runs it, and its local ops come back here
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation infers the global output shape
            # on fake tensors: no rank runs that
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            # as FlopCounterMode: an op with no formula may decompose into some
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if _is_dot(packet):
            self.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
            return out
        kind = _collective_kind(func)
        if kind and not self._quiet:
            self.collectives[kind] += _bytes(out)
        return out

    def result(self, entry: str = "step") -> dict:
        """The reference's ``analyze`` keys."""
        breakdown = {k: float(self.collectives.get(k, 0.0)) for k in COLLECTIVES}
        return {
            "entry": entry,
            "dot_flops_per_device": float(self.dot_flops),
            "collective_bytes_per_device": float(sum(breakdown.values())),
            "collective_breakdown": breakdown,
            "unparsed_whiles": 0,
        }


def analyze(fn, *args, **kwargs) -> dict:
    """Runs ``fn(*args, **kwargs)`` once under an ``Analysis`` and returns
    its counts under the reference's keys: ``dot_flops_per_device``,
    ``collective_bytes_per_device``, ``collective_breakdown`` (bytes by
    kind) and ``unparsed_whiles``."""
    with Analysis() as a:
        fn(*args, **kwargs)
    return a.result(getattr(fn, "__name__", "step"))
