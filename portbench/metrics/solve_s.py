"""solve_s: the window's seconds over the whole solves completed in it;
each solve from the call of solve() to its return (host clock)."""


def read(rec):
    done = [s for s in rec.solves if s.kernel is not None and not s.capped]
    if rec.trace is not None or not done:
        return None
    return (rec.solves[-1].t_return - rec.solves[0].t_call) / len(done)
