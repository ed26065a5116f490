"""``boruvka_round`` launches per request in the window, from the
program's launch counters: one Borůvka hooking round each, and one host
sync each."""


def read(run):
    launches = run.launches.get("boruvka_round", 0)
    if not launches or not run.attempted:
        return None
    return launches / run.attempted
