"""Share of the E-Branchformer's attention calls that ran the fused
relative-position attention kernel: the mean of the program's counter
`ebranchformer.attention_kernel`, one record a call, 1 on the kernel and 0
on the plain composition. None where the program records no such counter
(as a program without the kernel)."""

from benchlib import program_records


def read(run):
    return program_records.mean_value(run, "ebranchformer.attention_kernel")
