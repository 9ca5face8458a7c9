"""Share of the traced window, in %, in which card 0 ran no device
operation (kernels, copies, sets): 1 - busy / window, busy being the union
of card 0's device events' spans. Card 0 runs every stage that is not
split over a mesh."""


def read(rec):
    if not rec.get("window_s") or not rec.get("busy_s") or rec["busy_s"][0] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"][0] / rec["window_s"])
