"""kernels_per_step: kernels the card ran per profiled batched step."""


def read(seen):
    tr = seen.get("trace")
    if seen.get("unit") != "step" or not tr or not tr["units"]:
        return None
    return tr["kernels"] / tr["units"]
