"""``dispatch_wait_share``: the executor's dispatch lane's waits on the
pack lanes over the executor's wall, summed over the window's jobs
(``pipeline.device_idle_s`` / ``pipeline.wall_s`` of each run summary)."""


def read(run: dict):
    pipes = [j["pipeline"] for j in run["jobs"] if j.get("pipeline")]
    wall = sum(p["wall_s"] for p in pipes)
    if not pipes or wall <= 0:
        return None
    return sum(p["device_idle_s"] for p in pipes) / wall
