"""kernels_per_frame: kernels the card ran per profiled sweep."""


def read(seen):
    tr = seen.get("trace")
    if seen.get("unit") != "frame" or not tr or not tr["units"]:
        return None
    return tr["kernels"] / tr["units"]
