"""setup_s (host clock): from the process's start to the end of the
warm-up: imports, the weights and inputs made from the seed, the
program's preparation and calibration, kernel builds where there are
any, and one warmed batch of each shape the window uses."""


def read(rec):
    return rec.setup_s
