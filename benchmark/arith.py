"""The arithmetic the metric readers share."""


def per_gbp(seconds, bases):
    """Seconds per Gbp of input: seconds summed over the window's jobs
    over the bases those jobs took in."""
    return seconds / (bases / 1e9)


def job_sum(jobs, get):
    """Sum of get(job) over the jobs, or None when no job has it."""
    vals = [get(j) for j in jobs]
    vals = [v for v in vals if v is not None]
    return sum(vals) if vals else None


def overlap_stats(job):
    """The overlap engine's counters of a job: the sampleqc entry keeps
    them under stats["overlap"], the overlap entry at the top."""
    st = job["stats"]
    return st.get("overlap", st) if "phase_s" not in st else st
