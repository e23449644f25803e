"""recall: recall@k of the answers against the plain reference's exact
neighbours; in a search mix every answer of the window, in a build mix
one search of the last index built over the whole query set."""


def read(run):
    return run["numbers"]["recall"]
