"""The benchmark of hupr_tpu_torch on NVIDIA cards.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>
"""
