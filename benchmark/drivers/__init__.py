"""One module a kind of traffic (``traffic/<name>.json``'s ``driver``): its
general generator, the loop that offers it to the program, and the check
that decides ``correct``. ``run(cell)`` returns what ``run.py`` and the
metric readers take."""
