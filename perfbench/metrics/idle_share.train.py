"""idle_share.train: the share (%) of the traced stretch of training in
which no operation ran on the device (1 - the union of the device
operations' intervals over the stretch)."""


def read(run):
    st = run.stretch
    if run.kind != "train" or st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
