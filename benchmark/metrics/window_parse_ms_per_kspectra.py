"""``window_parse_ms_per_kspectra``: milliseconds of the streamed MGF
window parse per 1,000 spectra over the window's jobs: the pack lanes'
``window_parse`` phase (``phases_s["window_parse"]``), the clusters of
each chunk made from the input's byte index; it runs inside the lanes'
``pipeline.pack_busy_s``.  Nothing where a run summary lacks the phase."""


def read(run: dict):
    jobs = run["jobs"]
    if not jobs or any("window_parse" not in j.get("phases_s", {})
                       for j in jobs):
        return None
    parse = sum(j["phases_s"]["window_parse"] for j in jobs)
    return parse * 1e3 / (len(jobs) * run["spectra"] / 1e3)
