"""gloo for ranks that share one card. gloo takes CUDA tensors in few of its
collectives (and send/recv of one fails with a bad address), and NCCL takes
no two ranks on one device, so a world whose ranks share a card runs
``HostStagedGloo``: a process group that copies every CUDA tensor of a
collective to host memory, runs gloo on the copies and copies the result
back. The staging is explicit and counted: ``STAGED_BYTES`` and ``CALLS``
per collective, which the callers print. Host tensors go to gloo as they
are. Only the communication crosses host memory; every product stays on
the card.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import ProcessGroupGloo, _create_work_from_future

NAME = "gloo_staged"
STAGED_BYTES: Counter = Counter()  # collective -> bytes copied to and from the host
CALLS: Counter = Counter()  # collective -> calls with CUDA tensors


def register() -> None:
    """Make ``NAME`` a backend ``init_process_group`` can start."""
    if NAME.upper() not in dist.Backend._plugins:
        dist.Backend.register_backend(NAME, _create, extended_api=True,
                                      devices=["cpu", "cuda"])


def _create(opts, _pg_options, cls=None):
    pg = (cls or HostStagedGloo)(opts.store, opts.group_rank, opts.group_size, opts.timeout)
    pg._set_group_name(opts.group_id)
    return pg


def _done(result):
    fut = torch.futures.Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(t: torch.Tensor, op: str) -> torch.Tensor:
    STAGED_BYTES[op] += t.numel() * t.element_size()
    return t.cpu()


def _back(dst: torch.Tensor, src: torch.Tensor, op: str) -> None:
    STAGED_BYTES[op] += src.numel() * src.element_size()
    dst.copy_(src)


def _empty(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


class HostStagedGloo(dist.ProcessGroup):
    """A process group over gloo whose collectives take CUDA tensors by
    staging them through host memory (see the module docstring)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = ProcessGroupGloo(store, rank, size, timeout)
        # the group's name lives on its backends: gloo's stands for both
        # devices (every collective reaches the methods below first)
        for device in ("cpu", "cuda"):
            self._register_backend(torch.device(device), dist.ProcessGroup.BackendType.GLOO,
                                   self._gloo)

    def _staged(self, op: str, *tensors) -> bool:
        cuda = any(t.is_cuda for t in tensors)
        if cuda:
            CALLS[op] += 1
        return cuda

    def allreduce(self, tensors, opts=None):
        if not self._staged("allreduce", *tensors):
            return self._gloo.allreduce(tensors, opts)
        host = [_host(t, "allreduce") for t in tensors]
        self._gloo.allreduce(host, opts).wait()
        for t, h in zip(tensors, host):
            _back(t, h, "allreduce")
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        if not self._staged("allreduce", *tensors):
            return self._gloo.allreduce_coalesced(tensors, opts)
        host = [_host(t, "allreduce") for t in tensors]
        self._gloo.allreduce_coalesced(host, opts).wait()
        for t, h in zip(tensors, host):
            _back(t, h, "allreduce")
        return _done(tensors)

    def broadcast(self, tensors, opts=None):
        if not self._staged("broadcast", *tensors):
            return self._gloo.broadcast(tensors, opts)
        host = [_host(t, "broadcast") for t in tensors]
        self._gloo.broadcast(host, opts).wait()
        for t, h in zip(tensors, host):
            _back(t, h, "broadcast")
        return _done(tensors)

    def allgather(self, output_lists, inputs, opts=None):
        flat = [t for outs in output_lists for t in outs]
        if not self._staged("allgather", *inputs, *flat):
            return self._gloo.allgather(output_lists, inputs, opts)
        host_out = [[_empty(t) for t in outs] for outs in output_lists]
        self._gloo.allgather(host_out, [_host(t, "allgather") for t in inputs], opts).wait()
        for outs, hosts in zip(output_lists, host_out):
            for t, h in zip(outs, hosts):
                _back(t, h, "allgather")
        return _done(output_lists)

    def _allgather_base(self, output, inp, opts=None):
        if not self._staged("all_gather_into_tensor", output, inp):
            return self._gloo._allgather_base(output, inp, opts)
        host = _empty(output)
        self._gloo._allgather_base(host, _host(inp, "all_gather_into_tensor"), opts).wait()
        _back(output, host, "all_gather_into_tensor")
        return _done(output)

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for out, inp in zip(outputs, inputs):
            self._allgather_base(out, inp, opts).wait()
        return _done(outputs)

    def reduce_scatter(self, outputs, input_lists, opts=None):
        flat = [t for ins in input_lists for t in ins]
        if not self._staged("reduce_scatter", *outputs, *flat):
            return self._gloo.reduce_scatter(outputs, input_lists, opts)
        host = [_empty(t) for t in outputs]
        self._gloo.reduce_scatter(host, [[_host(t, "reduce_scatter") for t in ins]
                                         for ins in input_lists], opts).wait()
        for t, h in zip(outputs, host):
            _back(t, h, "reduce_scatter")
        return _done(outputs)

    def _reduce_scatter_base(self, output, inp, opts=None):
        if not self._staged("reduce_scatter_tensor", output, inp):
            return self._gloo._reduce_scatter_base(output, inp, opts)
        host = _empty(output)
        self._gloo._reduce_scatter_base(host, _host(inp, "reduce_scatter_tensor"), opts).wait()
        _back(output, host, "reduce_scatter_tensor")
        return _done(output)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for out, inp in zip(outputs, inputs):
            self._reduce_scatter_base(out, inp, opts).wait()
        return _done(outputs)

    def alltoall_base(self, output, inp, output_split_sizes, input_split_sizes, opts=None):
        if not self._staged("all_to_all", output, inp):
            return self._gloo.alltoall_base(output, inp, output_split_sizes,
                                            input_split_sizes, opts)
        host = _empty(output)
        self._gloo.alltoall_base(host, _host(inp, "all_to_all"), output_split_sizes,
                                 input_split_sizes, opts).wait()
        _back(output, host, "all_to_all")
        return _done(output)

    def barrier(self, opts=None):
        return self._gloo.barrier(opts)

    def send(self, tensors, dst: int, tag: int = 0):
        if not self._staged("send", *tensors):
            return self._gloo.send(tensors, dst, tag)
        self._gloo.send([_host(t, "send") for t in tensors], dst, tag).wait()
        return _done(tensors)

    def recv(self, tensors, src: int, tag: int = 0):
        if not self._staged("recv", *tensors):
            return self._gloo.recv(tensors, src, tag)
        host = [_empty(t) for t in tensors]
        self._gloo.recv(host, src, tag).wait()
        for t, h in zip(tensors, host):
            _back(t, h, "recv")
        return _done(tensors)
