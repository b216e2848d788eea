"""One module per driver kind, named by a traffic file's "kind"."""
