"""batched_step_ms: mean ms between CUDA events recorded before and after
each batched_frame_step of the traced run's window (one graph replay of all
lanes, its input copies included)."""


def read(seen):
    ms = seen.get("step_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
