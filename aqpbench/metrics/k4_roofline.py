"""K4's share (%) of its roofline over the window: the bound of each
launch's shapes over its device time, summed over launches."""


def read(rec):
    return (rec.get("rooflines") or {}).get("k4")
