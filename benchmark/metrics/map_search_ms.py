"""map_search_ms: mean device ms a sweep of the mapping step's search phase
(the program's ``mapping.search``) over the traced run's window: the grid's
recentring, the local maps' gather and the stacks' voxel downsample, then
in each outer iteration the 5-NN searches and the line and plane fits.
From timing events the program captures into the mapping graph at the
phase's boundaries (utils/timing.py ``phase``), added up over the sweep;
nothing where the program records no such phase."""


def read(seen):
    return seen.get("stage_ms", {}).get("mapping.search")
