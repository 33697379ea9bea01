"""``pack_ms_per_kspectra``: every pack lane's busy milliseconds per
1,000 spectra over the window's jobs (``pipeline.pack_busy_s``; with a
streamed input the windows' parse runs on the pack lanes too)."""


def read(run: dict):
    pipes = [j["pipeline"] for j in run["jobs"] if j.get("pipeline")]
    if not pipes:
        return None
    busy = sum(sum(p["pack_busy_s"]) for p in pipes)
    return busy * 1e3 / (len(run["jobs"]) * run["spectra"] / 1e3)
