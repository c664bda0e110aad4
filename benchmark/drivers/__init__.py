"""One driver per kind of entry point of the program; a traffic file names its driver."""
