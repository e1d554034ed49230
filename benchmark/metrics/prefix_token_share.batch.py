"""``prefix_token_share.batch``: prompt tokens the prefix index served
(``prefix_stats()["tokens_matched"]``'s growth over the window) over the
prompt tokens submitted in it."""


def read(layer):
    p = layer.get("prefix")
    if not p or not p[0].get("enabled"):
        return None
    matched = p[1]["tokens_matched"] - p[0]["tokens_matched"]
    submitted = sum(layer["requests"][rid][0] for rid in layer["counted"])
    return None if submitted <= 0 else 100.0 * matched / submitted
