"""The benchmark of lws_torch: `python -m portbench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
