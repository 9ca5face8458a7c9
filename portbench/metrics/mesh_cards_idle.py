"""Share of the traced window, in %, in which the cards that a mesh adds
ran no device operation: the mean over cards 1 to ``chips`` - 1 of 1 -
busy / window, busy being the union of a card's device events' spans
(``device_idle`` reads card 0). Nothing to read with fewer than two
cards, or where the builds booked no mesh span (``mesh.scan``): a
one-card build, or a program whose mesh carries no tracer."""


def read(rec):
    chips = int(rec.get("chips", 1))
    busy = rec.get("busy_s") or []
    if (chips < 2 or len(busy) < chips or not rec.get("window_s")
            or "mesh.scan" not in rec["books"]):
        return None
    idle = [1.0 - b / rec["window_s"] for b in busy[1:chips]]
    return 100.0 * sum(idle) / len(idle)
