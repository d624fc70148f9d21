"""One module a kind of deployment: how its circuits are set up, how one
request is served, and how the outputs are judged against the plain
reference."""
