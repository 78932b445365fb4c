"""decode.passes_per_token: weight passes (lookahead windows, or steps of
a token-a-pass loop) of the unbatched decodes over the tokens they served,
counted by the benchmark around the decode loops."""


def read(run):
    recs = [r for r in run.records if "passes" in r and r.get("ids")]
    tokens = sum(len(r["ids"]) for r in recs)
    if not tokens:
        return None
    return sum(r["passes"] for r in recs) / tokens
