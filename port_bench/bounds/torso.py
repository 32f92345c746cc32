"""Operations of the torso: a forward over ``rows`` frames is 2·macs·rows
(the torso file's multiply-adds, port_bench/reference/torsos/
<architecture>.py); a forward that autograd records costs twice that again
for its backward, every convolution's input and weight gradients, as
bounds/model_flops.py counts a backward (the first convolution's input
gradient is never computed: 2 % of the IMPALA ResNet's count). The bound
is that count at the peak of the operands' dtype (bounds/peaks.py)."""
from port_bench.bounds.peaks import bound_s
from port_bench.reference.rainbow import torso


def flops(architecture: str, history: int, frame: int, rows: int,
          recorded: bool) -> int:
    f = 2 * torso(architecture).macs(history, frame) * rows
    return 3 * f if recorded else f


def call_bound_s(architecture: str, history: int, frame: int, rows: int,
                 dtype: str, recorded: bool) -> float:
    return bound_s(flops(architecture, history, frame, rows, recorded), 0,
                   dtype)
