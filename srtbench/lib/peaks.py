"""Published peaks of one NVIDIA H100 SXM and the walk's unit costs
(frozen).

Bytes: 3.35 TB/s of HBM3.  The ALU pipe: 64 lanes an SM a clock, 132 SMs
at 1.98 GHz = 16.7 T instructions/s (min, max, compares, selects, logic,
shifts).  The FMA pipe: 128 FP32 lanes an SM a clock = 33.5 T
instructions/s (adds, multiplies, multiply-adds; half the 67 TFLOP/s that
counts a multiply-add as two).  A slab test of a box costs 14 ALU-pipe and
12 FMA-pipe instructions, a Woop evaluation of a triangle 11 and 46: the
fewest that any walk kernel's hot loop issued in the port's SASS when this
table was frozen, so a walk that issues more shows a lower share.  FP32
outside the tensor cores: 67 TFLOP/s.
"""

PEAK_BYTES_S = 3.35e12
PEAK_ALU_INSTR_S = 132 * 64 * 1.98e9
PEAK_FMA_INSTR_S = 67e12 / 2
PEAK_FP32_FLOP_S = 67e12
# unit: (ALU-pipe, FMA-pipe) instructions.
UNIT_OPS = {"slab": (14, 12), "woop": (11, 46)}
