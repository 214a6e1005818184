"""Host time from the entry into ``NeoLSSVM.fit`` to its call of ``upload_rows`` (validation,
``np.unique`` of the labels, the target and weight arrays, the padding), mean over the fits."""

from perfbench.probes_runtime import by_step
from perfbench.readers import mean_ms

PROBES = ("fit", "upload")


def read(ctx):
    entry = {s: recs[0]["t0"] for s, recs in by_step(ctx.records, "fit").items()}
    upload = {s: recs[0]["t0"] for s, recs in by_step(ctx.records, "upload").items()}
    return mean_ms({s: (upload[s] - entry[s]) * 1e3 for s in entry if s in upload})
