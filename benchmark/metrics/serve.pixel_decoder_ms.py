"""Device ms a batch between CUDA events recorded by forward hooks around
the model's pixel decoder (the stage timer of the port's serving profile
script), the mean over the traced window's batches."""


def read(r):
    if r.get("kind") != "serve":
        return None
    ms, calls = r["stage_ms"]["pixel_decoder"]
    return ms / calls if calls else None
