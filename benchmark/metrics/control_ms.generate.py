"""Milliseconds of the control path per controlled step: the ControlNet's and
the adapter's forward calls, each timed by CUDA events from its pre-hook to its
hook in the traced run's window, summed over the window and divided by the
controlled steps (the ControlNet's calls)."""


def read(record):
    towers = record.get("tower_ms", {})
    cn, ad = towers.get("controlnet"), towers.get("adapter")
    if not cn or not ad:
        return None
    return (sum(cn) + sum(ad)) / len(cn)
