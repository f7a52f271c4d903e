"""Images returned to the host by ``build_detector``'s ``infer`` a second,
over all the batches and all the time of the window: host canvases in,
host detections out, the pageable upload included."""


def read(run):
    c = run.outcome.recorder.counters
    if not c.get("seconds"):
        return None
    return (c["images"] - c.get("failed_images", 0)) / c["seconds"]
