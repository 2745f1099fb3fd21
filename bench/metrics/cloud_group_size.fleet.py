"""Mean requests a batched cloud launch: the fleet's ``cloud_groups`` that
a cut plan ran, over the window's calls before the traced slice."""
import statistics


def read(run):
    sizes = [n for s in run.spans("serve", part="before")
             for n in s["group_sizes"]]
    return statistics.fmean(sizes) if sizes else None
