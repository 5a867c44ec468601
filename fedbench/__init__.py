"""The benchmark of the PyTorch/CUDA port (`repro_torch`): FL rounds of
the port's `TorchTrainerHooks` on the card, held to a plain reference.
Run one cell with `python3 fedbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the repository's root."""
