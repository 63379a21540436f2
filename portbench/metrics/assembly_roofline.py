"""The reentry assembly's share of its roofline: the least time of every
launch of the window, from the work its inputs need
(portbench/harness/roofline.py), over the device time of the
assembly_kernel launches in the trace."""

from harness.trace import ASSEMBLY_KERNEL


def read(run):
    device_s = run.kernel_s.get(ASSEMBLY_KERNEL, 0.0)
    if run.asm_least_s is None or device_s <= 0:
        return None
    return 100.0 * run.asm_least_s / device_s
