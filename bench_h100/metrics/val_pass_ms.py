"""Host ms of the validation pass, from the call of the program's
``make_val_fn`` function to its Dice on the host (a sync), as the mean
over every untraced epoch of the window."""


def read(r):
    if r.kind != "train_epochs":
        return None
    v = r.host.get("val_pass_s") or []
    return 1e3 * sum(v) / len(v) if v else None
