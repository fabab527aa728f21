"""One module per kind of configuration: it builds the plants (the
benchmark's own world), drives the port through its public API, and holds
the plain reference that the port's answers are judged against."""
