"""Plain references under which the program is checked; nothing here imports the program."""
