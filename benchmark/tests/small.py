"""Traffic of each cell cut to a size the CPU runs in seconds: the same
drivers, configurations and comparison as the cells, fewer and shorter
utterances, fewer lanes.  Every lane of the small fleet is checked."""

SMALL = {
    "nat_block88.batch64": {
        "driver": "batch", "lanes": 4, "pool": 8,
        "lengths": {"samples": 16000}, "warmup_calls": 1, "check_calls": 2},
    "nat_block88.mixed64": {
        "driver": "batch", "lanes": 4, "pool": 8,
        "lengths": {"min_samples": 8000, "max_samples": 20000,
                    "length_seed": 7},
        "warmup_calls": 1, "check_calls": 2},
    "nat_frame.fleet": {
        "driver": "stream", "api": "fleet", "lanes": 4, "block_frames": 8,
        "wire": "samples", "tick_hops": 8, "utterance_samples": 8000,
        "warmup_ticks": 2, "check_lanes": 4, "check_frames": 48},
    "nat_frame.mic": {
        "driver": "stream", "api": "session", "block_frames": 1,
        "tick_hops": 1, "utterance_samples": 8000, "warmup_ticks": 5,
        "check_lanes": 1, "check_frames": 48},
}
