from . import kkbox, tmall
