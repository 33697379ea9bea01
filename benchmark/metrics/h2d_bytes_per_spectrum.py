"""``h2d_bytes_per_spectrum``: bytes the backend copied to the card per
spectrum (the run summaries' ``backend.h2d_bytes``, consensus and QC), a
count that repeats exactly."""


def read(run: dict):
    jobs = [j for j in run["jobs"] if "backend" in j]
    if not jobs:
        return None
    total = sum(sum(j["backend"]["h2d_bytes"].values()) for j in jobs)
    return total / (len(jobs) * run["spectra"])
