"""Host ms until the serving entry's ``infer`` returns (with the results'
copies queued), the mean over every batch of the traced window."""


def read(r):
    if r.get("kind") != "serve" or not r["enqueue_ms"]:
        return None
    return sum(r["enqueue_ms"]) / len(r["enqueue_ms"])
