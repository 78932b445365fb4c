"""engine.decode_ms_per_token: the engines' unbatched decode seconds
(``decode_device_s_total``, ended by a device synchronise) over the tokens
they decoded in the window, in ms a token."""


def read(run):
    d = run.engine_deltas
    if not d.get("decode_tokens"):
        return None
    return 1000.0 * d["decode_s"] / d["decode_tokens"]
