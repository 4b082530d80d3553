"""map_solve_ms: mean device ms a sweep of the mapping step's solve phase
(the program's ``mapping.solve``) over the traced run's window: the LM
solves of every outer iteration.  From timing events the program captures
into the mapping graph at the phase's boundaries (utils/timing.py
``phase``), added up over the sweep; nothing where the program records no
such phase."""


def read(seen):
    return seen.get("stage_ms", {}).get("mapping.solve")
