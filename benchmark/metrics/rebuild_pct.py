"""Share of the traced steps that rebuilt the sorted frame and its window
tables (the program's ``rebuilds`` counter), in percent."""


def read(ctx):
    return 100.0 * ctx["rebuilds"] / ctx["steps"]
