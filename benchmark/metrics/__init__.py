"""One reader per metric, metrics/<name>.py, found by the manifest's name.
A reader's read(record) returns the metric's value or None (nothing to
read: the harness leaves the metric out of the result line); SPANS names
the program functions it needs wrapped in spans in a traced run, and
note(record), where present, adds a line to standard error."""
