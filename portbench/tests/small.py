"""Small sizes of each cell that a CPU test run can hold."""

from portbench import harness

SIZES = {
    "fleet-48k-8192x16": ({"sessions": 8, "sample_sessions": 4, "warm_blocks": 1}, None),
    "fleet-48k-8192x15": ({"sessions": 8, "sample_sessions": 4, "warm_blocks": 1}, None),
}


def run_small(cell, seed=20240611, seconds=2.0, controls=()):
    sizes, config_sizes = SIZES[cell]
    return harness.run_cell(cell, seed, seconds, False, device="cpu", sizes=sizes,
                            config_sizes=config_sizes, controls=controls)
