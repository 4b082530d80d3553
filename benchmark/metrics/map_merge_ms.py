"""map_merge_ms: mean device ms a sweep of the mapping step's merge phase
(the program's ``mapping.merge``) over the traced run's window: the
odom-to-map correction and the merges of both stacks into the map stores.
From timing events the program captures into the mapping graph at the
phase's boundaries (utils/timing.py ``phase``); nothing where the program
records no such phase."""


def read(seen):
    return seen.get("stage_ms", {}).get("mapping.merge")
