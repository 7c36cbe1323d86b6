"""Share of slot-steps that decoded a request, from the engine's counters
over the window: ``n_slot_steps / (n_decode_steps * n_slots)``."""


def read(run):
    c0, c1 = run.window.counters0, run.window.counters1
    steps = c1["n_decode_steps"] - c0["n_decode_steps"]
    if steps == 0:
        return None
    return 100.0 * (c1["n_slot_steps"] - c0["n_slot_steps"]) / (steps * c1["n_slots"])
