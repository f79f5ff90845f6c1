"""Share of the delta's commodities kept rather than re-enumerated, in
percent: ``route/update/spliced`` over ``spliced + enumerated``, the
program's counters summed over the window's expansion steps."""


def read(run):
    spliced = run.layer.get("spliced")
    enumerated = run.layer.get("enumerated")
    if spliced is None or enumerated is None or not spliced + enumerated:
        return None
    return 100.0 * spliced / (spliced + enumerated)
