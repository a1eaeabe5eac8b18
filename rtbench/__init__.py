"""The benchmark of the PyTorch and CUDA port (``vsmartmom_torch``) on an
NVIDIA H100: ``python3 -m rtbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run``)."""
