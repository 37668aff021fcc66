"""Per cent of a wing decomposition's rounds whose triple space took two
or more ``wing_subtract`` tiles: the program's ``multi_tile_rounds``
counter over its ``rounds`` counter, summed over the window's
decompositions of op ``wings_limited`` made after the trace stopped.
None where the program keeps no such counter."""
UNIT = "%"


def read(run):
    multi = rounds = 0
    for c in run.steady("wings_limited"):
        counters = getattr(c["report"], "counters", {})
        if "multi_tile_rounds" in counters:
            multi += counters["multi_tile_rounds"]
            rounds += counters.get("rounds", 0)
    return 100.0 * multi / rounds if rounds else None
