"""Names by which the traced run sorts the card's operations.

Device operations are named by the profiler: the port's hand-written
kernels by their CUDA function names, copies as ``Memcpy HtoD`` /
``Memcpy DtoH``.  A library's
kernels are sorted by the host operation that launched them
(:data:`HOST_OPS`): ``aten::convolution_backward`` (data and weight
gradients) and ``aten::convolution`` (forward convs, the transposed ones
included)."""

HOST_OPS = ("aten::convolution_backward", "aten::convolution")


def is_conv3(name: str) -> bool:
    return "conv3_tc_kernel" in name or "conv3_direct_kernel" in name


def is_down4(name: str) -> bool:
    return "down4_tc_kernel" in name


def is_host_copy(name: str) -> bool:
    return name.startswith(("Memcpy HtoD", "Memcpy DtoH"))


def under(trace: dict, host_op: str) -> float:
    """Device seconds of the operations launched inside ``host_op``."""
    return trace["by_host_op"].get(host_op, 0.0)
