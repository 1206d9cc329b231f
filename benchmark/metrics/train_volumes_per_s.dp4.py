"""``train_volumes_per_s`` of the cells across cards, whose runs spread too
widely to share the one-card cells' bound: the same reading."""


def read(run):
    return run.volumes_per_s
