"""``mgf_io_ms_per_kspectra``: milliseconds of MGF input and output per
1,000 spectra over the window's jobs: the ``parse`` phase (with a
streamed input, the byte index; the windows' parse falls inside the pack
lanes' time) and the write lane's busy time (``pipeline.write_busy_s``)."""


def read(run: dict):
    jobs = run["jobs"]
    if not jobs:
        return None
    parse = sum(j["phases_s"].get("parse", 0.0) for j in jobs)
    write = sum((j.get("pipeline") or {}).get("write_busy_s", 0.0)
                for j in jobs)
    return (parse + write) * 1e3 / (len(jobs) * run["spectra"] / 1e3)
